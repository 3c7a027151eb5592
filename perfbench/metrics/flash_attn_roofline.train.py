"""flash_attn_roofline.train: the least time the attention forwards of
the traced training step need, one forward an application a microbatch
(``yardstick.attention_call_work``), over the device time of the
forward-attention kernels found by name (the port's flash attention and
PyTorch's SDPA forwards), in percent.  The backward is torch ops and is
not counted; the forward the backward recomputes is time but not work,
so this share is at most half of the kernel's own while units are
recomputed."""
from perfbench.bench import yardstick

PATTERNS = ("flash_fwd", "fmha_cutlassf", "flash_fprop")


def read(run):
    if run.trace is None or run.device.type != "cuda":
        return None
    kernel_s = run.trace.seconds_matching(PATTERNS)
    if kernel_s <= 0:
        return None
    accum = run.cell.traffic["grad_accum"]
    calls = accum * yardstick.attention_applications(run.model)
    least = sum(calls * yardstick.least_seconds(*yardstick.attention_call_work(run.model, b // accum, s))
                for b, s in run.traced["units"])
    return 100.0 * least / kernel_s
