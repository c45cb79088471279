"""mfu.train: the model FLOPs of the window's steps (the frozen count, 3x
the forward, recompute not counted) over the window's seconds times the
bf16 peak of every chip of the run, in percent."""
from benchmark import flops, hw


def read(run):
    s = run.stats
    if not s.get("seconds"):
        return None
    work = flops.gpt_train_step_flops(run.cfg, s["batch"], s["seq_len"])
    rate = work * s["steps"] / s["seconds"]
    return 100.0 * rate / (hw.peak(run.kind, "bf16_flops") * run.chips)
