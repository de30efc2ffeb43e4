"""batch_gap_share.offline: the card waiting for the pipeline's worker to
hand it the next batch.

For each batch whose runtime.decode span ended inside the traced slice
(`trace_interval`, on perf_counter), the device time from the previous
batch's copy to this batch's encode on the same stream: the program's CUDA
events at the end of the previous runtime.decode (the one begun last
before this batch's runtime.encode) and the start of this batch's
runtime.encode, which runs as the previous work ends where the stream is
still busy, else as the host begins queueing the encode. Summed over the
slice's batches, over the traced window's wall time (`window_s`, what
device_idle_share.offline divides by). Nothing where the program keeps no
timeline (`piper_tpu_torch.utils.profiling.RING`) or no such pair ran."""

SOURCE, LAYER, MOVES, UNIT = "device_trace", "serving pipeline", "audio_s_per_s", "%"


def read(ctx):
    from piper_tpu_torch.utils import profiling

    ring = getattr(profiling, "RING", None)
    interval = ctx.window.info.get("trace_interval")
    if not ring or not interval or not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    lo, hi = interval
    gap, last_decode, counted = {}, None, set()
    for r in sorted(ring, key=lambda r: r.t0):
        if r.name == "runtime.decode":
            last_decode = r
        elif r.name == "runtime.encode" and r.batch not in gap:
            prev = last_decode
            if prev is not None and prev.events is not None and r.events is not None:
                gap[r.batch] = prev.events[1].elapsed_time(r.events[0]) / 1e3
    for r in ring:
        if r.name == "runtime.decode" and lo < r.t1 <= hi and r.batch in gap:
            counted.add(r.batch)
    if not counted:
        return None
    return 100.0 * sum(gap[b] for b in counted) / ctx.trace["window_s"]
