"""Wall of the port's ``knn.prepare`` span: validation, the grid build on
the device and the class plan."""


def read(ctx):
    spans = [s for s in ctx.prepare_spans if s.get("name") == "knn.prepare"]
    return spans[-1]["dur_ms"] if spans else None
