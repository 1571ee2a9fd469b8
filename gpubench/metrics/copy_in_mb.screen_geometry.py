"""MB (2**20 bytes) copied from host arrays onto the card a request in the
geometry screen: the program's ``copy_in_bytes`` counter over three more
requests, over the ``predict.request`` spans (``gpubench.spans``); the
descriptors are made on the card, so only the packed CGR batch and the
geometries count."""

from gpubench import spans


def read(ctx):
    if ctx.traffic["kind"] != "screen_geometry":
        return None
    got = spans.stretch(ctx)
    req = None if got is None else got["summary"].get("predict.request")
    if not req:
        return None
    return got["counters"]["copy_in_bytes"] / 2**20 / req["count"]
