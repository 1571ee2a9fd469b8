"""Host ms of one checkpoint write (``RxnGraphTrainer.save`` through
``train/checkpoint.py::save_checkpoint``): the mean ``train.save`` span
over one more validation period of epochs (a latest checkpoint an epoch,
and a best one where validation improved), from the program's span log
(``gpubench.spans``)."""

from gpubench import spans


def read(ctx):
    if ctx.traffic["kind"] != "train_staged":
        return None
    s = spans.mean_s(ctx, "train.save")
    return None if s is None else 1e3 * s
