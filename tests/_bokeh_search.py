"""The bokeh kernels' searches written out in PyTorch
(``csrc/bokeh.cu``): the sampler's fixed-step search over
``bokeh_kernel.packed_tables`` and the plane entry's bracketed search over
``bokeh_kernel.plane_tables``.  Shared by the CPU tests of the tables;
imports no JAX."""

import torch

from zoic_tpu_torch.ops import bokeh_kernel as tbk


def fixed_step_upper_bound(a, off, n, u):
    """``csrc/bokeh.cu:upper_bound4`` over flat ``a``: ceil(log2 n)
    halvings of ``base`` with no branch, then one probe."""
    base = off.clone()
    length = n
    while length > 1:
        half = length >> 1
        base = base + torch.where(a[base + half] <= u, half, 0)
        length -= half
    return base - off + (a[base] <= u).long()


def kernel_search(packed, h, w, u1, u2):
    """The kernel's indexing of the packed tables, in PyTorch."""
    ws = w + 1
    zero = torch.zeros_like(u1, dtype=torch.int64)
    r = torch.clamp_max(fixed_step_upper_bound(packed, zero, h, u1), h - 1)
    off = 2 * h + r * ws
    c = torch.clamp_max(fixed_step_upper_bound(packed, off, w, u2), w - 1)
    return packed[off + h * ws + c], packed[h + r]


def decode(words, steps):
    """``(lo, hi)`` of guide words ``lo << steps | (hi - lo)``."""
    bits = words.view(torch.int32).long() & 0xFFFFFFFF
    lo = bits >> steps
    return lo, lo + (bits & ((1 << steps) - 1))


def bracket_search(a, words, off, steps, u):
    """``csrc/bokeh.cu:bracket_search4`` over flat ``a``: the bracket of
    guide word ``words`` (offset by ``off``), then ``steps`` steps by
    ``2**(steps-1), ..., 1``, no probe past its end."""
    pos, hi = decode(words, steps)
    pos, hi = pos + off, hi + off
    for s in reversed(range(steps)):
        p = pos + (1 << s)
        inside = p <= hi
        probe = a[torch.where(inside, p - 1, 0)]
        pos = torch.where(inside & (probe <= u), p, pos)
    return pos


def planes_search(t, h, w, u1, u2):
    """The plane entry's indexing of ``bokeh_kernel.plane_tables``
    (:class:`~zoic_tpu_torch.ops.bokeh_kernel.PlaneTables` ``t``), in PyTorch:
    slice ``u * K`` of each guide, then the bracketed searches."""
    ws, base = w + 1, tbk.table_floats(h, w)
    kr, kc = 1 << t.log2_kr, 1 << t.log2_kc
    words = t.words
    g = words[base + (u1 * kr).long()]
    r = bracket_search(words, g, torch.zeros_like(g, dtype=torch.int64),
                       t.steps_r, u1)
    g = words[base + kr + (r << t.log2_kc) + (u2 * kc).long()]
    c = bracket_search(words[2 * h:], g, r * ws, t.steps_c, u2)
    return words[2 * h + h * ws + c], words[h + r]
