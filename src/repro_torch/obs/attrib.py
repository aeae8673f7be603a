"""Performance attribution: a roofline-grounded per-family step cost model.

The paper's pitch is *predictability*: packed layouts exist so tile
shapes — and therefore step cost — are known before execution.  At
``Engine.warmup()`` time (and **only** then — the warmup-only contract
below) :func:`build_cost_model` builds a :class:`StepCostModel`: one
:class:`FamilyCost` for every step family on the engine's ladder (the
enumeration :func:`repro_torch.analysis.shapes.step_families` derives from
the warmup loop), priced against a
:class:`~repro_torch.core.hardware.HardwareSpec`:

    compute_s   = flops / peak_flops(compute dtype)
    memory_s    = hbm_bytes / hbm_bw
    predicted_s = max(compute_s, memory_s)        (the roofline)

The JAX package reads both counts from XLA's cost analysis of each
lowered family.  The port builds them at warmup on the card, where a
trace would cost more than the closed forms of the engine's own
geometry below; the traced graph is their check: the FLOPs of every step
family equal ``dot_flops`` of the step traced with fake tensors
(:func:`repro_torch.roofline.graph_cost.step_cost`), exactly
(``tests/test_torch_graph_cost.py::test_cost_model_equals_traced_graph``).

**FLOPs.**  With the layout tiles ``(m_r, n_r, k_r)``, ``L_a`` attention
layers of ``Hq`` query heads of width ``dh``, ``ru(x, t)`` = ``x``
rounded up to a multiple of ``t``, ``win = max_pages * page_tokens`` (the
block-table window), ``lin`` = ``Σ ru(K, k_r)·ru(N, n_r)`` over every
layer's packed linears (attention: Q, K, V, O and the MLP's gate, up,
down; mamba: in, x, out and the MLP; RWKV-6: the time-mix's r, k, v, g, o
and the channel-mix's r, k, v) and ``head = ru(vocab, n_r)·ru(d, k_r)``:

    flat[1,W]/kK:        M = ru(W, m_r)     R = ru(slots·K, m_r)   P = W
    chunk[B,S], prefill[1,S], decode[B,1]:
                         M = B·ru(S, m_r)   R = B·ru(1, m_r)       P = B·S
    chunk[B,S]/verify, verify[B,K]: as the base shape, but R = B·ru(K, m_r)

    flops = 2·M·lin + 2·R·head + 4·P·Hq·dh·win·L_a + P·rec + moe

— every packed linear over its padded tiles, the head (tied or not: the
same ``[d, vocab]`` product) over the ``R`` gathered rows, attention over
the whole window, and the recurrent layers' own work per token ``rec``,
unpadded: RWKV-6's decay LoRA (``2·2·d·64``, a plain float32 product)
and its recurrence (``4·H·dh²``: the read-out and the state update, two
multiply-adds per state element); mamba's ``dt_proj`` (``2·dt_rank·di``)
and its scan (``4·di·N``: update and read-out).  Mamba's depthwise
convolution is ``d_conv`` elementwise multiply-adds, which count nothing
here as no other elementwise chain does (ROADMAP C12: counted until PR 32,
where the traced graph showed no product there).  A moe layer's FFN (``cfg.moe_on_layer``) is no MLP in
``lin``: with ``C = capacity(P)`` (every token of the step routes, pads
included) its term is ``moe = 2·E·ru(C, m_r)·Σ ru(K, k_r)·ru(N, n_r)``
over the expert linears (gate, up, down of ``d x d_ff_expert``: every
expert's capacity-padded rows, as the dispatch runs them) plus the
router's ``2·P·d·E`` (a plain float32 product), and arctic's parallel
dense MLP joins ``lin``.  Without recurrent layers this is the dot-FLOP count XLA
reports for the JAX package's families, to the FLOP
(``tests/test_torch_attrib.py`` holds the two equal, for SmolLM2, for
Qwen2-7B's QKV bias and Qwen3-8B's qk_norm and untied head, and for
qwen3-moe's and arctic's expert products); with them,
XLA's count is the port's less the parts that are no dot: the
recurrences' state updates (ROADMAP C8).  A
bias, a norm (RWKV-6's group norm included) and the qk-norm are no dots,
and count nothing.  A static engine (the encdec and vlm families, whose vision
prefix runs in the static loop's prefill) has no warmup and no cost model,
in either package.

**Bytes** are the port's own count, not the JAX package's:

    hbm_bytes = itemsize(compute dtype)·(lin + head)       packed weights
              + itemsize·E·Σ ru(K, k_r)·ru(N, n_r)        every expert
              + plain                                      unpacked products
              + rows·win·kv_page_bytes_per_token           KV gather
              + 2·rows·state_bytes_per_row                 recurrent state
              + 4·R·vocab                                  float32 logits

— each prepacked weight read once per step (the tied head's packed table
included; every expert's, since the capacity dispatch runs every
expert), the weights of the plain products (RWKV-6's float32 LoRA,
mamba's ``dt_proj``, the float32 router), the KV pages of every gathering row's window
(``rows`` = the slots for a flat step, ``B`` otherwise), each row's
recurrent state read and written once, and the float32 logits of the
``R`` gathered rows.  XLA's byte count depends on how it fuses a step (it
counts activations, the per-step pack of the stacked layer weights and
every unfused intermediate), so no closed form reproduces it; the port
counts the traffic a step cannot avoid, which makes ``predicted_s`` the
step's floor on the card.  Norm and qk-norm weights, biases and the
embedding rows gathered are left out (a few KB a step).  ``kv_gather_bytes`` is the JAX package's
term exactly.

Per-step attribution happens on the telemetry side
(:mod:`repro_torch.obs.telemetry`): each measured step is tagged with the
family label(s) it executed, its wall time is split into
``sched + device + draft + host`` (exact by construction — the split is
derived from the step's own span timestamps, so the components sum to the
measured wall), and *padding waste* prices the step's padded positions:
``(width - real_tokens) * per_token_s`` of the family's roofline cost.
Per-drain rollups (:func:`summarize`) report MFU/MBU, achieved- vs
roofline-tokens/s, padding-waste ratio and goodput.

Warmup-only contract: nothing in this module runs per step, and building
the model calls no model step, no compiled step and no graph table, so it
moves no ``trace_counts`` and captures nothing.  The cost model is a
frozen dict after :func:`build_cost_model` returns; the per-step hot path
only ever does a dict lookup and float arithmetic on the host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch

from repro_torch.core.layout import round_up

__all__ = ["FamilyCost", "StepCostModel", "build_cost_model",
           "kv_page_bytes_per_token", "state_bytes_per_row", "fresh_totals",
           "update_aggregates",
           "finalize_summary", "summarize"]


@dataclasses.dataclass(frozen=True)
class FamilyCost:
    """Predicted cost of one step family (one ladder shape)."""

    label: str                 # e.g. "flat[1,64]/k1", "chunk[4,16]/verify"
    width: int                 # padded token positions per step (the grid)
    flops: float               # dot FLOPs per step
    hbm_bytes: float           # modelled HBM traffic per step
    kv_gather_bytes: float     # block-table-window KV gather traffic
    compute_s: float           # flops / peak_flops(dtype)
    memory_s: float            # hbm_bytes / hbm_bw
    kv_gather_s: float         # kv_gather_bytes / hbm_bw
    predicted_s: float         # max(compute_s, memory_s) — the roofline
    per_token_s: float         # predicted_s / width (padding-waste price)
    bottleneck: str            # "compute" | "memory"

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class StepCostModel:
    """The per-family roofline table, frozen at warmup.

    ``families`` maps the family label (the same string the engine tags
    measured steps with) to its :class:`FamilyCost`.  ``hw``/``dtype``
    record what the prediction was priced against; ``flops_per_token`` is
    the model-FLOPs rate used for MFU (2·N_active per token)."""

    hw_name: str
    dtype: str
    peak_flops: float
    hbm_bw: float
    flops_per_token: float
    families: Dict[str, FamilyCost]

    def get(self, label: str) -> Optional[FamilyCost]:
        return self.families.get(label)

    def to_dict(self) -> dict:
        return {
            "hw": self.hw_name, "dtype": self.dtype,
            "peak_flops": self.peak_flops, "hbm_bw": self.hbm_bw,
            "flops_per_token": self.flops_per_token,
            "families": {k: v.to_dict() for k, v in self.families.items()},
        }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def kv_page_bytes_per_token(caches, num_pages: int, page_tokens: int) -> float:
    """Bytes of paged K/V per cached token, summed over every page-pool
    tensor — those with an adjacent ``(num_pages, page_tokens)`` dim pair
    (``[layers, num_pages, page_tokens, heads, d_head]``)."""
    total = 0.0
    for leaf in _leaves(caches):
        shape = tuple(leaf.shape)
        if any(shape[i] == num_pages and shape[i + 1] == page_tokens
               for i in range(len(shape) - 1)):
            total += (leaf.numel() * leaf.element_size()
                      / (num_pages * page_tokens))
    return total


def state_bytes_per_row(caches, slots: int) -> float:
    """Bytes of recurrent state per slot: every per-slot leaf of the cache
    tree (``[G, slots, ...]``; the ``*_pages`` pools are not)."""
    if isinstance(caches, dict):
        return sum(0.0 if k.endswith("_pages") else state_bytes_per_row(v, slots)
                   for k, v in caches.items())
    return caches.numel() * caches.element_size() / slots


def _layer_costs(cfg, t: str, itemsize: int, moe_layer: bool = False) -> tuple:
    """(the packed linears [(K, N)], recurrent FLOPs per token, bytes of
    the plain products' weights) of one layer of type ``t``; a moe layer's
    (``moe_layer``) linears hold arctic's dense branch and not the MLP
    (its experts and router: :func:`_expert_costs`)."""
    d, f = cfg.d_model, cfg.d_ff
    mlp = [(d, f), (f, d)] + ([(d, f)] if cfg.glu else [])
    if moe_layer and not cfg.dense_residual:
        mlp = []
    if t == "rwkv":
        h, dh = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        lora = 64                             # models/rwkv6.py:_DECAY_LORA
        return ([(d, d)] * 6 + [(d, f), (f, d)],
                2 * 2 * d * lora + 4 * h * dh * dh, 4 * 2 * d * lora)
    if t == "mamba":
        di, n = cfg.mamba_expand * d, cfg.mamba_d_state
        dt_rank = -(-d // 16)
        return ([(d, 2 * di), (di, dt_rank + 2 * n), (di, d)] + mlp,
                2 * dt_rank * di + 4 * di * n,
                itemsize * dt_rank * di)
    dh, hq, hkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads
    return ([(d, hq * dh), (d, hkv * dh), (d, hkv * dh), (hq * dh, d)] + mlp,
            0, 0)


def _expert_costs(cfg) -> list:
    """One expert's linears [(K, N)] (gate, up, down)."""
    d, f = cfg.d_model, cfg.d_ff_expert
    return [(d, f), (f, d)] + ([(d, f)] if cfg.glu else [])


def build_cost_model(engine, hw=None) -> StepCostModel:
    """Price every step family of ``engine`` against ``hw`` (default:
    :func:`repro_torch.core.hardware.query` of the engine's device; on the
    card its own descriptor whatever ``$REPRO_HW`` says, since a scaled
    descriptor's peaks are not the card's) in closed form — see the module
    docstring for the counts.  Runs once, at warmup, and touches no model
    step."""
    from repro_torch.analysis.shapes import step_families
    from repro_torch.core.hardware import query
    from repro_torch.models.moe import capacity

    if hw is None:
        own = "h100" if engine.device.type == "cuda" else None
        hw = query(engine.device, own)
    model, cfg = engine.model, engine.model.cfg
    dtype = model.compute_dtype
    peak = hw.peak_flops(dtype)
    layout = model.ctx.layout(dtype)
    m_r, n_r, k_r = layout.m_r, layout.n_r, layout.k_r
    lin = rec = plain = 0
    n_moe = 0
    for i, t in enumerate(cfg.layer_types):
        mats, r, b = _layer_costs(cfg, t, dtype.itemsize, cfg.moe_on_layer(i))
        lin += sum(round_up(k, k_r) * round_up(n, n_r) for k, n in mats)
        rec, plain = rec + r, plain + b
        n_moe += cfg.moe_on_layer(i)
    e = cfg.n_experts
    expert = n_moe * e * sum(round_up(k, k_r) * round_up(n, n_r)
                             for k, n in _expert_costs(cfg)) if n_moe else 0
    plain += 4 * n_moe * cfg.d_model * e                     # the routers
    n_attn = cfg.layer_types.count("attn")
    head = round_up(cfg.vocab, n_r) * round_up(cfg.d_model, k_r)
    win = engine.max_pages * engine.pool.page_tokens
    kv_per_token = kv_page_bytes_per_token(
        engine.caches, engine.pool.num_pages, engine.pool.page_tokens)
    state_per_row = state_bytes_per_row(engine.caches, engine.slots)
    weight_bytes = dtype.itemsize * (lin + head + expert) + plain

    families: Dict[str, FamilyCost] = {}
    for label, g in step_families(engine):
        m = g.batch * round_up(g.seq, m_r)
        r = (round_up(g.rows * g.logits, m_r) if g.kind == "flat"
             else g.batch * round_up(g.logits, m_r))
        p = g.batch * g.seq
        moe = (2 * round_up(capacity(p, cfg), m_r) * expert
               + 2 * p * cfg.d_model * e * n_moe) if n_moe else 0
        flops = float(2 * m * lin + 2 * r * head + p * rec + moe
                      + 4 * p * cfg.n_heads * cfg.d_head * win * n_attn)
        gather = g.rows * win * kv_per_token
        nbytes = float(weight_bytes + gather + 2 * g.rows * state_per_row
                       + 4 * r * cfg.vocab)
        compute_s = flops / peak
        memory_s = nbytes / hw.hbm_bw
        predicted = max(compute_s, memory_s)
        families[label] = FamilyCost(
            label=label, width=g.width, flops=flops, hbm_bytes=nbytes,
            kv_gather_bytes=gather, compute_s=compute_s, memory_s=memory_s,
            kv_gather_s=gather / hw.hbm_bw, predicted_s=predicted,
            per_token_s=predicted / max(1, g.width),
            bottleneck="compute" if compute_s >= memory_s else "memory")

    n_active = cfg.param_counts()["active"]
    return StepCostModel(hw_name=hw.name, dtype=str(dtype).replace("torch.", ""),
                         peak_flops=peak, hbm_bw=hw.hbm_bw,
                         flops_per_token=2.0 * n_active, families=families)


def fresh_totals() -> dict:
    """A zeroed drain-total accumulator (see :func:`update_aggregates`)."""
    return {"steps": 0, "wall_s": 0.0, "sched_s": 0.0, "device_s": 0.0,
            "draft_s": 0.0, "host_s": 0.0, "predicted_s": 0.0,
            "padding_waste_s": 0.0, "real_tokens": 0, "padded_tokens": 0}


def update_aggregates(tot: dict, fams: Dict[str, dict], rec: dict,
                      cost_model: Optional[StepCostModel]) -> None:
    """Fold one per-step attribution record into the running drain
    aggregates (mutates ``tot``/``fams`` in place).  Incremental so the
    telemetry's bounded per-step window can drop old records without the
    drain summary losing them."""
    tot["steps"] += 1
    tot["wall_s"] += rec["wall"]
    tot["sched_s"] += rec["sched"]
    tot["device_s"] += rec["device"]
    tot["draft_s"] += rec["draft"]
    tot["host_s"] += rec["host"]
    for label, real, width, dev_s in rec["families"]:
        f = fams.setdefault(label, {
            "steps": 0, "real_tokens": 0, "padded_tokens": 0,
            "device_s": 0.0, "predicted_s": 0.0, "padding_waste_s": 0.0})
        f["steps"] += 1
        f["real_tokens"] += real
        f["padded_tokens"] += width
        f["device_s"] += dev_s
        fc = cost_model.get(label) if cost_model is not None else None
        if fc is not None:
            f["predicted_s"] += fc.predicted_s
            f["padding_waste_s"] += (width - real) * fc.per_token_s
        tot["real_tokens"] += real
        tot["padded_tokens"] += width
        tot["predicted_s"] += fc.predicted_s if fc is not None else 0.0
        tot["padding_waste_s"] += ((width - real) * fc.per_token_s
                                   if fc is not None else 0.0)


def finalize_summary(tot: dict, fams: Dict[str, dict],
                     cost_model: Optional[StepCostModel], *,
                     goodput_tokens: int = 0,
                     tokens_out: int = 0) -> dict:
    """The per-drain attribution view over the running aggregates:
    component totals, per-family predicted-vs-measured, MFU/MBU, padding
    waste, achieved- vs roofline-tokens/s and goodput.

    MFU uses *useful* model FLOPs (real tokens x 2·N_active) over
    measured wall x peak; MBU uses the families' modelled HBM bytes over
    wall x bandwidth — both are honest about padding (padded positions
    burn wall time but earn no useful FLOPs, so waste lowers MFU exactly
    as it should)."""
    fams = {label: dict(f) for label, f in fams.items()}
    for f in fams.values():
        f["fill"] = f["real_tokens"] / max(1, f["padded_tokens"])
        f["predicted_vs_measured"] = (f["predicted_s"] / f["device_s"]
                                      if f["device_s"] > 0 else 0.0)
    wall = tot["wall_s"]
    out = {"totals": dict(tot), "families": fams}
    if cost_model is not None and wall > 0:
        useful_flops = tot["real_tokens"] * cost_model.flops_per_token
        modelled_bytes = sum(
            f["steps"] * cost_model.get(l).hbm_bytes
            for l, f in fams.items() if cost_model.get(l) is not None)
        out["mfu"] = useful_flops / (wall * cost_model.peak_flops)
        out["mbu"] = modelled_bytes / (wall * cost_model.hbm_bw)
        out["padding_waste_ratio"] = (tot["padding_waste_s"]
                                      / max(tot["device_s"], 1e-12))
        out["achieved_tokens_per_s"] = tot["real_tokens"] / wall
        out["roofline_tokens_per_s"] = (
            tot["real_tokens"] / tot["predicted_s"]
            if tot["predicted_s"] > 0 else math.inf)
        out["roofline_fraction"] = (tot["predicted_s"] / wall
                                    if wall > 0 else 0.0)
    out["goodput_tokens"] = goodput_tokens
    out["tokens_out"] = tokens_out
    out["goodput_ratio"] = goodput_tokens / max(1, tokens_out)
    return out


def summarize(step_records: List[dict], cost_model: Optional[StepCostModel],
              *, goodput_tokens: int = 0, tokens_out: int = 0) -> dict:
    """One-shot :func:`finalize_summary` over a list of step records
    (the standalone path; the live telemetry aggregates incrementally)."""
    tot, fams = fresh_totals(), {}
    for rec in step_records:
        update_aggregates(tot, fams, rec, cost_model)
    return finalize_summary(tot, fams, cost_model,
                            goodput_tokens=goodput_tokens,
                            tokens_out=tokens_out)
