"""Static engine configuration (compile-time shape parameters).

Mirrors the reference ABI's configure/preset/introspection surface:
``_configure(channels, blockSamples, intervalSamples, splitComputation)``,
``_presetDefault(channels, sampleRate)``, ``_presetCheaper(channels,
sampleRate)``, ``_blockSamples``, ``_intervalSamples``, ``_inputLatency``,
``_outputLatency`` (reference: app/SignalsmithStretch.mjs:461-466, 791-796).

Everything here is *static*: changing it recompiles the step function, just
as the reference resets its engine on configure
(app/SignalsmithStretch.mjs:791-792).  Dynamic per-stream controls live in
:class:`bauklank_tpu_torch.engine.params.StretchParams`.
"""

from __future__ import annotations

import dataclasses

__all__ = ["StretchConfig", "preset_default", "preset_cheaper"]


@dataclasses.dataclass(frozen=True)
class StretchConfig:
    """Shape-defining engine configuration.

    channels:  audio channels per stream (reference default: stereo).
    block:     STFT block (window) size in samples; rounded up to even.
    interval:  synthesis hop in samples (``intervalMs = blockMs / overlap``
               in the app layer — reference: app/multi/app.mjs:409-417).
    split_computation: latency knob only on TPU.  The reference spreads
               spectral work across render quanta at the cost of one extra
               interval of output latency (README-signalsmith.md:1-31); the
               TPU engine always computes whole hops in one dispatch, so
               this flag just reproduces the reported-latency semantics.
    formants:  compile the formant-envelope path (compile-time off switch
               for streams that never touch formant controls).
    """

    channels: int = 2
    block: int = 8820
    interval: int = 2205
    split_computation: bool = True
    formants: bool = True
    # Kaiser beta override for the analysis window (None = the overlap
    # heuristic in ops.windows.kaiser_beta_for_overlap).  The calibration
    # dial for matching the reference blob's window empirically
    # (docs/FIDELITY-PLAN.md step 2).
    window_beta: float | None = None
    # Per-band phase re-anchoring on onsets: when a band's energy jumps by
    # more than this many dB between the previous-interval analysis and the
    # current one, its output phase restarts from the input phase (re-anchors
    # attacks at extreme stretch; None disables — the default, matching the
    # reference's continuous-phase behavior).  Implemented as a
    # reset-semigroup associative scan, so hop parallelism is preserved.
    transient_reset_db: float | None = None

    def __post_init__(self):
        from bauklank_tpu_torch.ops.fftsize import fast_fft_size

        # Round the block up to an FFT-fast size — the reference's DSP core
        # likewise picks a fast FFT size at/above the requested block.  On
        # this hardware an unlucky composite size costs >4x per FFT
        # (see bauklank_tpu/ops/fftsize.py for measurements).
        object.__setattr__(self, "block", fast_fft_size(self.block))
        if self.interval < 1:
            object.__setattr__(self, "interval", 1)
        if self.interval > self.block:
            object.__setattr__(self, "interval", self.block)

    # ---- reference ABI introspection -------------------------------------
    @property
    def bins(self) -> int:
        return self.block // 2

    @property
    def input_latency(self) -> int:
        """Samples of input lookahead (reference `_inputLatency`)."""
        return self.block // 2

    @property
    def output_latency(self) -> int:
        """Samples of output delay (reference `_outputLatency`).

        splitComputation adds one interval (README-signalsmith.md:26-31).
        """
        return self.block // 2 + (self.interval if self.split_computation else 0)

    @property
    def seek_len(self) -> int:
        """Length of the seek window: must hold the current analysis frame
        and the frame one interval earlier.  Equals the reference worklet's
        ``bufferLength = inputLatency + outputLatency`` when
        splitComputation is on (app/SignalsmithStretch.mjs:806)."""
        return self.block + self.interval

    @property
    def overlap(self) -> float:
        return self.block / self.interval


def preset_default(channels: int, sample_rate: float, split_computation: bool = True) -> StretchConfig:
    """120 ms block / 30 ms interval — the reference `_presetDefault` ratio
    (app/SignalsmithStretch.mjs:796)."""
    return StretchConfig(
        channels=channels,
        block=round(sample_rate * 0.12),
        interval=round(sample_rate * 0.03),
        split_computation=split_computation,
    )


def preset_cheaper(channels: int, sample_rate: float, split_computation: bool = True) -> StretchConfig:
    """100 ms block / 40 ms interval — the reference `_presetCheaper` ratio
    (app/SignalsmithStretch.mjs:795)."""
    return StretchConfig(
        channels=channels,
        block=round(sample_rate * 0.1),
        interval=round(sample_rate * 0.04),
        split_computation=split_computation,
    )
