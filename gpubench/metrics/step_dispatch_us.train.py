"""Host us to enqueue one staged training step (``RxnGraphTrainer
._run_steps``: the gradients through K2's wrapper and ``optimizer.step()``,
the card's work not waited for): the mean ``train.step`` span over one
more validation period of epochs, from the program's span log
(``gpubench.spans``)."""

from gpubench import spans


def read(ctx):
    if ctx.traffic["kind"] != "train_staged":
        return None
    s = spans.mean_s(ctx, "train.step")
    return None if s is None else 1e6 * s
