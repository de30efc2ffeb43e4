"""read_gap_share.offline: split mode's one host read, on the card's clock.

For each batch whose runtime.decode span ended inside the traced slice
(`trace_interval`, on perf_counter), the device time from the encode's last
operation to the host beginning the decode: the program's CUDA events at
the end of runtime.encode (behind the encode's work, which the card is
still running) and the start of runtime.decode (on the stream the read left
idle, so it runs as the host records it). Between them: the frame counts'
copy, the host's wake-up from the read, the bucket choice. The host's
preparation of the decode's first launch, after the start event, counts
in the decode. Summed over the slice's batches, over the traced window's
wall time (`window_s`, what device_idle_share.offline divides by). Nothing
where the program keeps no timeline
(`piper_tpu_torch.utils.profiling.RING`) or no such batch ran."""

SOURCE, LAYER, MOVES, UNIT = "device_trace", "runtime", "audio_s_per_s", "%"


def read(ctx):
    from piper_tpu_torch.utils import profiling

    ring = getattr(profiling, "RING", None)
    interval = ctx.window.info.get("trace_interval")
    if not ring or not interval or not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    lo, hi = interval
    encode, gap_s, batches = {}, 0.0, 0
    for r in sorted(ring, key=lambda r: r.t0):
        if r.name == "runtime.encode":
            encode[r.batch] = r
        elif r.name == "runtime.decode" and lo < r.t1 <= hi:
            enc = encode.get(r.batch)
            if enc is None or enc.events is None or r.events is None:
                continue
            gap_s += enc.events[1].elapsed_time(r.events[0]) / 1e3
            batches += 1
    if not batches:
        return None
    return 100.0 * gap_s / ctx.trace["window_s"]
