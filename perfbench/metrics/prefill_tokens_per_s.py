"""prefill_tokens_per_s: the prompt tokens of every batch of the window
over the window's seconds, from its start to the completion of its last
batch (host clock; a batch completes when its answers reach the host)."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.window["tokens"] / run.window["seconds"]
