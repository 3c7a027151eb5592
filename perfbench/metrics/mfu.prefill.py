"""mfu.prefill: the model FLOPs of the window's prefills
(``yardstick.prefill_flops``: matmuls at 2 FLOPs a weight a token, the
head at each prompt's last token, causal attention as half the square)
over the window's seconds times the H100's bf16 peak, in percent."""
from perfbench.bench import yardstick


def read(run):
    if run.device.type != "cuda":
        return None
    flops = sum(yardstick.prefill_flops(run.model, b, s) for b, s in run.window["units"])
    return 100.0 * flops / (run.window["seconds"] * yardstick.PEAK_BF16_FLOPS)
