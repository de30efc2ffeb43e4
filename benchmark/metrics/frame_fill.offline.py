"""frame_fill.offline: the share of the decode's work that is speech, not
padding.

Over the runtime.decode spans that ended inside the traced slice
(`trace_interval`, on perf_counter): the live frames of the real rows
(`frames`) over the rows decoded, padded rows included (`rows` +
`padded_rows`), times the frame bucket the batch decoded at (`f_bucket`),
both summed. The runtime's own counts, on the span's attributes. Nothing
where the program keeps no timeline (`piper_tpu_torch.utils.profiling.RING`)
or no decode ended in the slice."""

SOURCE, LAYER, MOVES, UNIT = "host_clock", "runtime", "audio_s_per_s", "%"


def read(ctx):
    from piper_tpu_torch.utils import profiling

    ring = getattr(profiling, "RING", None)
    interval = ctx.window.info.get("trace_interval")
    if not ring or not interval:
        return None
    lo, hi = interval
    live = decoded = 0
    for r in ring:
        if r.name == "runtime.decode" and lo < r.t1 <= hi:
            a = r.attrs
            live += a["frames"]
            decoded += (a["rows"] + a["padded_rows"]) * a["f_bucket"]
    if not decoded:
        return None
    return 100.0 * live / decoded
