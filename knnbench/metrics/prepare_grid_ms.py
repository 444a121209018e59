"""Wall of the port's ``prepare.grid`` span, a child of ``knn.prepare``:
the grid build on the device and the read of its cell counts to the host,
the one wait on the build."""


def read(ctx):
    spans = [s for s in ctx.prepare_spans if s.get("name") == "prepare.grid"]
    return spans[-1]["dur_ms"] if spans else None
