"""The device time per served frame of the kernels launched under the
program's `eval.encode_frame` span in the traced stretch, in ms: the device
total the profiler gives the span's host event, which sums the kernels it
links to the span and to the ops inside it, K1's ctypes launches included
(not the kernels that merely ran while the span was open). A program
without the span gives nothing."""

SPAN = "racformer.eval.encode_frame"


def span_device_ms(trace, name):
    """The device ms the profiler links to the host events named `name`
    (None where it links none)."""
    from torch.autograd import DeviceType

    us = sum(e.device_time_total if hasattr(e, "device_time_total")
             else e.cuda_time_total for e in trace.averages
             if e.key == name and e.device_type == DeviceType.CPU)
    return us / 1e3 if us > 0 else None


def read(ctx):
    ms = span_device_ms(ctx.trace, SPAN)
    return None if ms is None else ms / (ctx.trace.units * ctx.frames_per_step)
