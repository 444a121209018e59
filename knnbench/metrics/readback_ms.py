"""Device time of the device-to-host copies, a solve, from the
profiler."""


def read(ctx):
    cap = ctx.device_capture()
    if cap is None:
        return None
    s = cap.device_s(("gpu_memcpy",), lambda name: "DtoH" in name)
    return s / cap.solves * 1e3 if s > 0 else None
