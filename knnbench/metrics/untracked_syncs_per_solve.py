"""Host-blocking runtime calls inside a ``kntpu:knn.solve`` range and
outside every ``kntpu:dispatch.fetch`` range, a traced solve: waits that
no program counter sees.  The calls: ``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, the blocking
``cudaMemcpy``, ``cudaFree`` and ``cudaFreeHost``
(``knnbench/scopes.py`` ``BLOCKING_CALLS``)."""

from knnbench import scopes


def read(ctx):
    cap = ctx.device_capture()
    if cap is None or not scopes.ranges(cap, "knn.solve"):
        return None
    return len(scopes.untracked_syncs(cap)) / cap.solves
