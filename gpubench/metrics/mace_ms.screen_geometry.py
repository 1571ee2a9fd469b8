"""Host ms of one window's MACE inside a request: the ``mace.forward``
spans of three more requests (``models.MACE.descriptors``, its kernels'
launches and the work between them), summed and divided by the windows
they ran, from the program's span log (``gpubench.spans``)."""

from gpubench import spans


def read(ctx):
    if ctx.traffic["kind"] != "screen_geometry":
        return None
    got = spans.stretch(ctx)
    s = None if got is None else got["summary"].get("mace.forward")
    if not s:
        return None
    return 1e3 * s["total_s"] / s["count"]
