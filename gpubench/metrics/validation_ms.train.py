"""Host ms of one validation pass (``RxnGraphTrainer._val_epoch``): the
mean ``train.validate`` span over one more validation period of epochs,
read from the program's span log (``gpubench.spans``)."""

from gpubench import spans


def read(ctx):
    if ctx.traffic["kind"] != "train_staged":
        return None
    s = spans.mean_s(ctx, "train.validate")
    return None if s is None else 1e3 * s
