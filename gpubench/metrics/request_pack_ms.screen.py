"""Host ms to pack one batch inside a request: the ``predict.pack`` spans
(each ``next()`` of ``PackedLoader`` inside ``predict``, the one that
finds the loader's end included) over three more requests, summed and
divided by the batches they packed (the ``predict.forward`` spans), from
the program's span log (``gpubench.spans``)."""

from gpubench import spans


def read(ctx):
    if ctx.traffic["kind"] != "screen":
        return None
    got = spans.stretch(ctx)
    s = None if got is None else got["summary"]
    if not s or "predict.pack" not in s or "predict.forward" not in s:
        return None
    return 1e3 * s["predict.pack"]["total_s"] / s["predict.forward"]["count"]
