"""MB (2**20 bytes) copied from host arrays onto the card a request: the
program's ``copy_in_bytes`` counter over three more requests, over the
``predict.request`` spans (``gpubench.spans``)."""

from gpubench import spans


def read(ctx):
    if ctx.traffic["kind"] != "screen":
        return None
    got = spans.stretch(ctx)
    req = None if got is None else got["summary"].get("predict.request")
    if not req:
        return None
    return got["counters"]["copy_in_bytes"] / 2**20 / req["count"]
