"""Wall of the port's ``prepare.plan`` span, a child of ``knn.prepare``:
the class plan from the host's cell counts, and its packs on the device."""


def read(ctx):
    spans = [s for s in ctx.prepare_spans if s.get("name") == "prepare.plan"]
    return spans[-1]["dur_ms"] if spans else None
