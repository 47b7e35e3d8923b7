"""Installation topology SSOT: controllers -> channels -> encoders.

Re-creates the reference's single source of truth for which hardware rotary
encoder drives which engine channel (reference: time_pitch_mapping.py —
TIME_PITCH_TOPOLOGY :43-49, iteration helpers :52-68, import-time validation
:71-86), including the C header generation for encoder firmware that the
reference mentions but does not ship (header comment
time_pitch_mapping.py:13-15 names generate_time_pitch_mapping_header.py,
absent from the repo).
"""

from __future__ import annotations

import dataclasses

__all__ = ["TimePitchTopology", "DEFAULT_TOPOLOGY"]


@dataclasses.dataclass(frozen=True)
class TimePitchTopology:
    """mapping: {controller_id: {channel: encoder_id}}"""

    mapping: dict[str, dict[str, str]]

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Channels must be A/B; encoder ids unique across the installation."""
        seen: dict[str, str] = {}
        for ctrl, chans in self.mapping.items():
            if not chans:
                raise ValueError(f"controller {ctrl!r} has no channels")
            for ch, enc in chans.items():
                if ch not in ("A", "B"):
                    raise ValueError(f"controller {ctrl!r}: bad channel {ch!r}")
                if not isinstance(enc, str) or not enc:
                    raise ValueError(f"controller {ctrl!r}/{ch}: bad encoder id {enc!r}")
                if enc in seen:
                    raise ValueError(
                        f"encoder {enc!r} mapped twice ({seen[enc]} and {ctrl}/{ch})"
                    )
                seen[enc] = f"{ctrl}/{ch}"

    # ----------------------------------------------------------- iteration
    def controllers(self) -> list[str]:
        return sorted(self.mapping)

    def encoder_for(self, controller_id: str, channel: str) -> str | None:
        return self.mapping.get(controller_id, {}).get(channel)

    def channel_encoder_ids(self, controller_id: str) -> dict[str, str]:
        """Per-channel encoder ids used to decorate controllerStatus
        (reference: server-multi.py:26-31, 643-649)."""
        return dict(self.mapping.get(controller_id, {}))

    def items(self):
        for ctrl in self.controllers():
            for ch in sorted(self.mapping[ctrl]):
                yield ctrl, ch, self.mapping[ctrl][ch]

    # ------------------------------------------------------------- codegen
    def c_header(self, guard: str = "TIME_PITCH_MAPPING_H") -> str:
        """Generate the encoder-firmware C header the reference alludes to."""
        lines = [
            f"#ifndef {guard}",
            f"#define {guard}",
            "",
            "/* Generated from bauklank_tpu.models.topology — do not edit. */",
            "",
            "typedef struct {",
            "  const char *controller_id;",
            "  const char *channel;  /* \"A\" or \"B\" */",
            "  const char *encoder_id;",
            "} time_pitch_entry_t;",
            "",
            "static const time_pitch_entry_t TIME_PITCH_TOPOLOGY[] = {",
        ]
        for ctrl, ch, enc in self.items():
            lines.append(f'  {{"{ctrl}", "{ch}", "{enc}"}},')
        lines += [
            "};",
            "",
            "#define TIME_PITCH_TOPOLOGY_LEN "
            f"{sum(1 for _ in self.items())}",
            "",
            f"#endif /* {guard} */",
            "",
        ]
        return "\n".join(lines)


# A default two-channel, single-controller installation shape.
DEFAULT_TOPOLOGY = TimePitchTopology(
    mapping={"controller-1": {"A": "encoder-time", "B": "encoder-pitch"}}
)
