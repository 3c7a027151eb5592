"""train_tokens_per_s: the tokens of every step of the window over the
seconds from its start to the completion of its last step (host clock; a
step completes when its loss reaches the host), read as
``prefill_tokens_per_s`` reads its window."""
from pathlib import Path

from perfbench.bench import spec

read = spec.load_module(Path(__file__).with_name("prefill_tokens_per_s.py"),
                        "perfbench_metric_prefill_tokens_per_s").read
