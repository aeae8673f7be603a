"""Sample arguments for each ``torch.ops.repro_torch`` op, small and valid
for both its CPU impl (the plain version) and its CUDA impl (the kernel),
for ``torch.library.opcheck``.  Imports no JAX: the card's tests use it
too."""

import numpy as np
import torch

from repro_torch.kernels.ragged_attn.ops import plan_ragged
from repro_torch.kernels.selective_scan.ops import checkpoints as scan_checkpoints
from repro_torch.kernels.wkv6.ops import checkpoints as wkv6_checkpoints


def op_samples(device) -> list:
    """``[(op name, case id, args), ...]`` on ``device``, float32."""
    g = torch.Generator().manual_seed(0)
    dev = torch.device(device)

    def rn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def ru(*shape):
        return torch.rand(shape, generator=g).to(dev)

    out = []
    a = rn(37, 70)
    out.append(("pack", "contiguous", (a, 16, 64)))
    out.append(("pack", "transposed", (rn(70, 37).t(), 16, 64)))
    out.append(("unpack", "partial", (rn(3, 2, 16, 64), 40, 100)))
    ap, bp = rn(3, 2, 16, 64), rn(2, 2, 64, 64, scale=0.1)
    out.append(("mmt4d", "plain", (ap, bp, None, None, None)))
    out.append(("mmt4d", "bias-silu-unpacked", (ap, bp, rn(2, 64), "silu", [40, 100])))
    out.append(("mmt4d", "experts", (rn(2, 3, 2, 16, 64), rn(2, 2, 2, 64, 64, scale=0.1),
                                     None, "gelu", None)))
    out.append(("mmt4d", "partial-unpacked", (ap, bp, None, None, [40, 100], True)))
    dz, z = rn(3, 2, 16, 64), rn(3, 2, 16, 64)
    out.append(("mmt4d_dgrad", "silu", (dz, bp, z, "silu", None)))
    out.append(("mmt4d_dgrad", "experts", (rn(2, 3, 2, 16, 64), rn(2, 2, 2, 64, 64),
                                           None, None, None)))
    out.append(("mmt4d_wgrad", "silu-bias", (dz, ap, z, "silu", True, False, None)))
    out.append(("mmt4d_wgrad", "experts", (rn(2, 3, 2, 16, 64), rn(2, 3, 2, 16, 64),
                                           None, None, False, True, None)))
    # ragged attention: two rows and two padding positions over 16-token pages
    row_ids = np.array([0] * 12 + [1] * 6 + [-1] * 2, np.int32)
    q_pos = np.concatenate([np.arange(20, 32), np.arange(5, 11), [0, 0]]).astype(np.int32)
    bt = torch.tensor([[1, 2, 3], [4, 5, 0]], dtype=torch.int32, device=dev)
    items, splits = None, 1
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = plan_ragged(row_ids, q_pos, 16, 3, 2, sms, group=2).to(dev)
        items, splits = plan.items, plan.splits
    out.append(("ragged_attn", "two-rows", (
        rn(20, 4, 64), rn(6, 16, 2, 64), rn(6, 16, 2, 64), bt,
        torch.from_numpy(row_ids).to(dev), torch.from_numpy(q_pos).to(dev),
        items, splits)))
    # its partial form: the pools hold global pages 2 .. 4 and a trash slot
    out.append(("ragged_attn_partial", "pages-2-4", (
        rn(20, 4, 64), rn(4, 16, 2, 64), rn(4, 16, 2, 64), bt,
        torch.from_numpy(row_ids).to(dev), torch.from_numpy(q_pos).to(dev),
        items, splits, 2, 3)))
    r, k, v = rn(1, 40, 2, 16), rn(1, 40, 2, 16), rn(1, 40, 2, 16)
    w, u, s0 = 0.5 + 0.5 * ru(1, 40, 2, 16), rn(2, 16), rn(1, 2, 16, 16)
    ck = wkv6_checkpoints(r)
    out.append(("wkv6", "ckpt", (r, k, v, w, u, s0, torch.empty_like(s0), ck)))
    out.append(("wkv6_bwd", "ds", (r, k, v, w, u, s0, rn(1, 40, 2, 16),
                                   rn(1, 2, 16, 16), rn(*ck.shape))))
    delta = torch.nn.functional.softplus(rn(1, 50, 64) - 2)
    x, zz, b, c = rn(1, 50, 64), rn(1, 50, 64), rn(1, 50, 16), rn(1, 50, 16)
    a_log = torch.log(torch.arange(1, 17, dtype=torch.float32)).repeat(64, 1).to(dev)
    d_skip, h0 = 1 + rn(64, scale=0.1), rn(1, 64, 16)
    sck = scan_checkpoints(delta, x.dtype, 16)
    out.append(("selective_scan", "ckpt", (delta, x, zz, b, c, a_log, d_skip,
                                           h0.clone(), sck)))
    out.append(("selective_scan_bwd", "h0", (delta, x, zz, b, c, a_log, d_skip, h0,
                                              rn(1, 50, 64), rn(*sck.shape))))
    return out
