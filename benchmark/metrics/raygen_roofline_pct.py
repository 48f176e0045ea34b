"""The floor time of the traced window's calls (``counts/``, against the
published peaks) over the sum of every device operation's time in those
calls, in %.  Read only where the CUDA events around the calls, the card's
sum and the floor stand as events >= card >= floor; else nothing."""

from benchmark.core import peaks, profile


def read(ctx):
    t = ctx.traced
    lit = sum(int((w != 0).sum()) for w in t["weights"])
    flops, nbytes = ctx.count.floor(ctx.cam, ctx.lens_path, sum(t["sizes"]),
                                    lit)
    floor, by = peaks.floor_s(flops, nbytes)
    card = profile.device_s(ctx.trace)
    ctx.note(f"raygen_roofline_pct: {len(t['sizes'])} calls, {sum(t['sizes'])} "
             f"rays, {lit} lit; {flops} FLOP, {nbytes} B; floor {floor:.6g} s "
             f"(bound by {by}; peaks {peaks.FLOPS_F32:g} FLOP/s, "
             f"{peaks.BYTES_PER_S:g} B/s; card {ctx.card}), device sum "
             f"{card:.6g} s, events {t['events_s']:.6g} s")
    if not t["events_s"] >= card >= floor > 0.0:
        ctx.note("raygen_roofline_pct: no reading (events >= card >= floor "
                 "does not hold)")
        return None
    return 100.0 * floor / card
