"""MB (2**20 bytes, as the program's staged MB) copied from host arrays
onto the card an epoch: the program's ``copy_in_bytes`` counter over one
more validation period of epochs (staged epochs: the seeds and the
validation batches), over its epochs (``gpubench.spans``)."""

from gpubench import spans


def read(ctx):
    if ctx.traffic["kind"] != "train_staged":
        return None
    got = spans.stretch(ctx)
    if got is None or "train.epoch" not in got["summary"]:
        return None
    return (got["counters"]["copy_in_bytes"] / 2**20
            / ctx.traffic["val_frequency"])
