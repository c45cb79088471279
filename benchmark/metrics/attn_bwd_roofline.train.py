"""attn_bwd_roofline.train: attention's backward, whatever implements it:
the device time of every operation launched from inside the autograd
node ``FlashAttentionFunctionBackward`` in the profiled steps, against
the least time of the work the shapes define (causal dQ, dK, dV and dP,
4·B·H·T²·D, at the bf16 peak, or q, k, v, o, dO read and dq, dk, dv
written once at the HBM rate), one backward per layer and step, in
percent."""
from benchmark import flops, hw


def read(run):
    summary = run.summary
    if summary is None:
        return None
    ops = summary.launched_under(
        lambda name: "FlashAttentionFunctionBackward" in name)
    if not ops:
        return None
    s, cfg = run.stats, run.cfg
    work = flops.causal_attention_bwd(s["batch"], cfg["n_heads"],
                                      s["seq_len"], cfg["head_dim"], 2)
    bound = hw.roofline_seconds(work["flops"], work["bytes"], run.kind)
    calls = cfg["n_layers"] * s["trace_steps"]
    took = sum(e - b for _, b, e, _ in ops) / 1e9
    return 100.0 * bound * calls / took
