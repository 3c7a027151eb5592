"""mfu.train: the model FLOPs of the window's training steps
(``yardstick.train_flops``: three forwards, the head at every token, the
recompute left out) over the window's seconds times the H100's bf16 peak,
in percent."""
from perfbench.bench import yardstick


def read(run):
    if run.device.type != "cuda":
        return None
    flops = sum(yardstick.train_flops(run.model, b, s) for b, s in run.window["units"])
    return 100.0 * flops / (run.window["seconds"] * yardstick.PEAK_BF16_FLOPS)
