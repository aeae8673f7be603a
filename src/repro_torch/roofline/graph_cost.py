"""Costs read off a traced step: the JAX package's ``roofline/hlo_cost.py``
(``parse_hlo``) and ``roofline/hlo_parse.py`` (``collective_bytes``,
``count_ops``) on the aten graph ``make_fx`` records.

Where the reference parses XLA's HLO text, the port has a graph
(:func:`repro_torch.analysis.graph_tools.trace_step`: the step on fake
tensors, each kernel one ``torch.ops.repro_torch`` node), so one module
does both.  :func:`graph_cost` gives a :class:`GraphCost`:

- ``dot_flops``: the products and the kernels' work, from a formula table
  keyed by op (:data:`FLOPS`), never from what implements them, so a later
  kernel swap leaves the count as it is:

  - ``aten.mm`` / ``addmm`` ``2·M·N·K``, ``bmm`` / ``baddbmm`` ``2·B·M·N·K``
    (``matmul``, ``einsum`` and ``linear`` reach the graph as these);
  - ``repro_torch.mmt4d`` and its gradients over padded tiles,
    ``2·M_o·m_r·N_o·n_r·K_o·k_r`` (leading dims, experts included, folded
    into M_o);
  - ``repro_torch.ragged_attn`` under the closed form's whole-window
    convention ``4·W·Hq·dh·MP·T`` (scores and values over every page of
    the block table's window);
  - ``repro_torch.wkv6`` ``4·H·dh²`` and ``repro_torch.selective_scan``
    ``4·di·N`` a token, as :func:`repro_torch.obs.attrib._layer_costs`
    has them; a backward kernel is twice its forward's;

- ``hbm_bytes``: each launched node's tensor operands and outputs (views
  and ``getitem`` launch nothing), the reference's unfused-op measure;
- ``op_counts``: nodes by op (``aten.mm``, ``repro_torch.mmt4d``, ...);
- ``collective_bytes`` / ``collective_counts``: the operand bytes of each
  ``c10d_functional`` collective node, by op (the reference's
  ``collective_bytes``: operand sizes, an async collective once).

The closed forms the cost model (:func:`repro_torch.obs.attrib.
build_cost_model`) and the dry-run (:mod:`repro_torch.launch.dryrun`) write
by hand are held to this count: ``tests/test_torch_graph_cost.py``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import operator
from typing import Dict

import torch

from repro_torch.analysis.graph_tools import iter_nodes, op_name

__all__ = ["GraphCost", "graph_cost", "step_cost", "FLOPS"]


def _shape(a) -> tuple:
    return tuple(a.meta["val"].shape)


def _mm(a, b, *_):
    (m, k), n = _shape(a), _shape(b)[-1]
    return 2 * m * n * k


def _bmm(a, b, *_):
    (bt, m, k), n = _shape(a), _shape(b)[-1]
    return 2 * bt * m * n * k


def _mmt4d(a, b, *_):
    *lead, mo, k_o, m_r, k_r = _shape(a)
    n_o, _, n_r, _ = _shape(b)[-4:]
    return 2 * math.prod(lead) * mo * m_r * n_o * n_r * k_o * k_r


def _dgrad(dz, b, *_):
    *lead, mo, n_o, m_r, n_r = _shape(dz)
    _, k_o, _, k_r = _shape(b)[-4:]
    return 2 * math.prod(lead) * mo * m_r * n_o * n_r * k_o * k_r


def _wgrad(dz, a, *_):
    *lead, mo, n_o, m_r, n_r = _shape(dz)
    _, k_o, _, k_r = _shape(a)[-4:]
    return 2 * math.prod(lead) * mo * m_r * n_o * n_r * k_o * k_r


def _ragged(q, k_pages, v_pages, block_tables, *_):
    w, hq, dh = _shape(q)
    t = _shape(k_pages)[1]
    return 4 * w * hq * dh * _shape(block_tables)[1] * t


def _wkv6(r, *_):
    b, s, h, dh = _shape(r)
    return 4 * b * s * h * dh * dh


def _scan(delta, x, z, b, c, a_log, *_):
    rows, s, di = _shape(delta)
    return 4 * rows * s * di * _shape(a_log)[-1]


_aten = torch.ops.aten
# op -> FLOPs of one node from its arguments (their traced values)
FLOPS = {
    _aten.mm.default: _mm,
    _aten.addmm.default: lambda bias, a, b, *_: _mm(a, b),
    _aten.bmm.default: _bmm,
    _aten.baddbmm.default: lambda bias, a, b, *_: _bmm(a, b),
    "repro_torch.mmt4d": _mmt4d,
    "repro_torch.mmt4d_dgrad": _dgrad,
    "repro_torch.mmt4d_wgrad": _wgrad,
    "repro_torch.ragged_attn": _ragged,
    # a rank's share counts the whole table's keys, as the whole form does:
    # which pages a rank holds is data, not shape
    "repro_torch.ragged_attn_partial": _ragged,
    "repro_torch.wkv6": _wkv6,
    "repro_torch.wkv6_bwd": lambda *a: 2 * _wkv6(*a),
    "repro_torch.selective_scan": _scan,
    "repro_torch.selective_scan_bwd": lambda *a: 2 * _scan(*a),
}


@dataclasses.dataclass
class GraphCost:
    """The costs of one traced step (module docstring)."""

    dot_flops: float
    hbm_bytes: float
    op_counts: Dict[str, int]
    collective_bytes: Dict[str, float]
    collective_counts: Dict[str, int]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def kernel_counts(self) -> Dict[str, int]:
        """The ``repro_torch`` ops' counts, by kernel name."""
        return {k.split(".", 1)[1]: v for k, v in self.op_counts.items()
                if k.startswith("repro_torch.")}


def _bytes(v) -> int:
    if isinstance(v, torch.Tensor):
        return v.numel() * v.element_size()
    if isinstance(v, (list, tuple)):
        return sum(_bytes(x) for x in v)
    return 0


def _launches(node) -> bool:
    """Whether a node runs work on the device: an op that is not a view."""
    t = node.target
    return (node.op == "call_function" and isinstance(t, torch._ops.OpOverload)
            and not t.is_view)


def _is_collective(target) -> bool:
    """A functional collective; ``wait_tensor`` waits on one already
    counted (as the reference skips an async collective's ``-done``)."""
    return (isinstance(target, torch._ops.OpOverload)
            and target.namespace in ("_c10d_functional", "c10d_functional")
            and not target._schema.name.endswith("wait_tensor"))


def graph_cost(gm: torch.fx.GraphModule) -> GraphCost:
    """The costs of a traced step (module docstring)."""
    flops = 0
    nbytes = 0
    counts: collections.Counter = collections.Counter()
    coll_b: Dict[str, float] = collections.defaultdict(float)
    coll_n: collections.Counter = collections.Counter()
    for _, node in iter_nodes(gm):
        if node.op != "call_function" or node.target is operator.getitem:
            continue
        name = op_name(node.target)
        counts[name] += 1
        rule = FLOPS.get(node.target) or FLOPS.get(name)
        if rule is not None:
            flops += rule(*node.args)
        if _launches(node):
            ins = [a.meta.get("val") for a in node.all_input_nodes]
            nbytes += _bytes(ins) + _bytes(node.meta.get("val"))
        if _is_collective(node.target):
            b = _bytes([a.meta.get("val") for a in node.all_input_nodes])
            coll_b[name] += b
            coll_n[name] += 1
    return GraphCost(dot_flops=float(flops), hbm_bytes=float(nbytes),
                     op_counts=dict(counts), collective_bytes=dict(coll_b),
                     collective_counts=dict(coll_n))


def step_cost(engine, label: str) -> GraphCost:
    """:func:`graph_cost` of ``engine``'s step family ``label`` (a label of
    :func:`repro_torch.analysis.shapes.step_families`), traced with fake
    tensors on the engine's device."""
    from repro_torch.analysis.aliasing import step_args
    from repro_torch.analysis.graph_tools import trace_step

    fn, args, _ = step_args(engine, label)
    return graph_cost(trace_step(fn, args, device=engine.device))
