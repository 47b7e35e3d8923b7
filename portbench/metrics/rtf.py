"""Seconds of voice audio rendered in the window (steps x S x H x
interval / SR) over the window's wall seconds: all the work over all the
time, the knob turns sent between steps included."""


def read(run):
    return len(run.step_times) * run.audio_s_per_step / run.window_s
