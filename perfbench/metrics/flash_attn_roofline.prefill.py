"""flash_attn_roofline.prefill: the least time the attention forwards of
the traced stretch need (``yardstick.attention_call_work`` a block a
batch: the larger of FLOPs at the bf16 peak and bytes at the HBM
bandwidth) over the device time of the kernels that do that work, in
percent.  The kernels are found by name: the port's flash attention and
PyTorch's SDPA forwards, so work routed from one to the other still
reads the same work."""
from perfbench.bench import yardstick

PATTERNS = ("flash_fwd", "fmha_cutlassf", "flash_fprop")


def read(run):
    if run.trace is None or run.device.type != "cuda":
        return None
    kernel_s = run.trace.seconds_matching(PATTERNS)
    if kernel_s <= 0:
        return None
    calls = yardstick.attention_applications(run.model)
    least = sum(calls * yardstick.least_seconds(*yardstick.attention_call_work(run.model, b, s))
                for b, s in run.traced["units"])
    return 100.0 * least / kernel_s
