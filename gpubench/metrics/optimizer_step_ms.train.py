"""Host ms of one ``optimizer.step()`` of the trainer on the last step's
gradients, synchronized, averaged over the calls that fill 0.3 s."""

import torch

from gpubench.card import host_ms


def read(ctx):
    if ctx.traffic["kind"] != "train_staged" or ctx.device.type != "cuda":
        return None
    opt = ctx.program["trainer"].optimizer

    def step():
        opt.step()
        torch.cuda.synchronize(ctx.device)
    return host_ms(step)
