"""flash_fwd_roofline.train: the causal flash forward kernel
(``csrc/flash_attn_fwd.cu``, ``flash_fwd``) in the profiled steps: the
sum of each launch's least time (the larger of its causal FLOPs at the
bf16 peak and its q, k, v and o bytes at the HBM rate) over the kernel's
device time, in percent. Every launch of a step has the cell's shapes."""
from benchmark import flops, hw


def read(run):
    summary = run.summary
    if summary is None:
        return None
    calls = summary.kernels(lambda name: "flash_fwd" in name)
    if not calls:
        return None
    s, cfg = run.stats, run.cfg
    work = flops.causal_attention_fwd(s["batch"], cfg["n_heads"],
                                      s["seq_len"], cfg["head_dim"], 2)
    bound = hw.roofline_seconds(work["flops"], work["bytes"], run.kind)
    took = sum(e - b for _, b, e, _ in calls) / 1e9
    return 100.0 * bound * len(calls) / took
