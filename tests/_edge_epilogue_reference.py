"""The edge stage's epilogue kernels (``csrc/edge_epilogue.cu``) in plain
PyTorch, in the kernels' order: two-pass moments in the input's dtype and
the hand-written backward (any float dtype: f64 for gradient checks).

``through_reference`` points ``ops/edge_epilogue`` at these on the CPU:
``EdgeEpilogue`` runs them in place of its launches, which count as the
kernels' do, and every f32 edge stage routes to it.

Imported by tests/test_torch_port_edge_epilogue.py and
tests/test_torch_port_edge_epilogue_cuda.py.
"""

import torch

from sgnn_tpu_torch.nn.core import LN_EPS
from sgnn_tpu_torch.ops import edge_epilogue as ee


def stats(o, b2):
    """(xhat, rstd) of the rows of y = o + b2."""
    y = o + b2
    mean = y.mean(dim=-1, keepdim=True)
    xc = y - mean
    rstd = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + LN_EPS)
    return xc * rstd, rstd


def fwd_reference(o, b2, lns, lnb, mask, e, k: int):
    """The forward kernel: o, e ``[R*K, D]``, mask ``[R*K, 1]``; (new_e, agg)."""
    xhat, _ = stats(o, b2)
    msg = (xhat * lns + lnb) * mask
    return (e + msg) * mask, msg.reshape(-1, k, msg.shape[-1]).sum(dim=1)


def bwd_reference(o, b2, lns, mask, g_new, g_agg, k: int):
    """The backward kernel: (g_o, g_e, g_b2, g_lns, g_lnb). g_new
    ``[R*K, D]`` and g_agg ``[R, D]`` may be None (zero)::

        g_msg = g_new * mask + g_agg[r];  g_ln = g_msg * mask;  g_xhat = g_ln * lns
        g_o   = rstd * (g_xhat - mean(g_xhat) - xhat * mean(g_xhat * xhat))
        g_e   = g_new * mask
    """
    xhat, rstd = stats(o, b2)
    g_e = torch.zeros_like(o) if g_new is None else g_new * mask
    g_msg = g_e if g_agg is None else g_e + g_agg.repeat_interleave(k, dim=0)
    g_ln = g_msg * mask
    g_x = g_ln * lns
    g_o = rstd * (g_x - g_x.mean(dim=-1, keepdim=True) - xhat * (g_x * xhat).mean(dim=-1, keepdim=True))
    return g_o, g_e, g_o.sum(dim=0), (g_ln * xhat).sum(dim=0), g_ln.sum(dim=0)


def _launch_fwd(o, b2, lns, lnb, mask, e, k: int):
    if o.shape[0]:
        ee.LAUNCHES += 1
    return fwd_reference(o, b2, lns, lnb, mask, e, k)


def _launch_bwd(o, b2, lns, mask, g_new, g_agg, k: int):
    if o.shape[0]:
        ee.BWD_LAUNCHES += 1
    return bwd_reference(o, b2, lns, mask, g_new, g_agg, k)


def through_reference(monkeypatch) -> None:
    """Route every f32 edge stage to ``EdgeEpilogue`` and have it run the
    references (counted as launches), counters set to 0."""
    monkeypatch.setattr(ee, "takes", lambda device, dtype: dtype == torch.float32)
    monkeypatch.setattr(ee, "_launch_fwd", _launch_fwd)
    monkeypatch.setattr(ee, "_launch_bwd", _launch_bwd)
    monkeypatch.setattr(ee, "LAUNCHES", 0)
    monkeypatch.setattr(ee, "BWD_LAUNCHES", 0)
