"""mfu.serve: the model FLOPs of every served request's real prompt and
decode tokens (the frozen serving count) over the seconds the engine's
prefill and decode programs took for them (its histograms
``serving_prefill_seconds`` and ``serving_decode_step_seconds``, each
call ended by the copy of its result to the host), times the bf16 peak,
in percent."""
from benchmark import hw


def read(run):
    s = run.stats
    if not s.get("program_seconds"):
        return None
    rate = s["model_flops"] / s["program_seconds"]
    return 100.0 * rate / (hw.peak(run.kind, "bf16_flops") * run.chips)
