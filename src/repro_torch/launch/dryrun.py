"""Multi-device dry-run: price every (architecture x shape x mesh) cell of
the distributed configuration without allocating a weight, the JAX
package's ``launch/dryrun.py``.

The JAX package lowers and compiles each cell's step against 512 forced
host devices and reads its costs from the HLO.  The port builds each
cell's trees on the **meta** device (the model's own init through
:class:`MetaGenerator`, the optimizer's state, the caches and the batch:
the reference's tree paths, shapes and dtypes, nothing allocated), places
every leaf with the sharding rules (:mod:`repro_torch.distributed.sharding`)
on an :class:`~repro_torch.launch.mesh.AbstractMesh` of the production
topology, and counts per device in closed form:

**FLOPs**, the port's cost model (:mod:`repro_torch.obs.attrib`) over the
cell's shapes, read off the parameter leaves that hold each product's
weight: every packed linear over its padded tiles ``2·M·ru(K, k_r)·ru(N,
n_r)`` (M the step's rows rounded to m_r per sequence: the decoder's, the
encoder's for whisper's encoder, frontend and cross K/V, the vision
tokens' for the vlm projection), the head over the rows whose logits are
taken, the experts over their capacity rows (``blocks · capacity(P /
blocks)`` rounded to m_r), the routers, attention over the whole window
``4·P·Hq·dh·win`` a layer (whisper's encoder and cross-attention too),
the recurrences' own work a token; a train step is the forward three
times (backward twice), four with ``remat``.  Each device takes a data
shard's tokens where the batch divides over the data axes (attention:
a share of every data device's, a batch they do not divide being
sequence-sharded), and each product's share over "model" as its
weight's spec gives it: split where the spec shards a dim over "model",
whole where it does not (a dim the axis does not divide is left whole),
and the K and V projections whole where the KV heads are fewer than the
axis's size (the JAX package's rule).
A tied head is the one product whose weight, the embedding, has no dim
over "model" (its vocab is over "data", for the token gather): the
product gathers it over "data" and splits the vocab over "model" where
it divides, as the JAX package's compiled step does.  The head is outside
``remat``: three passes in a train step.  A head of attention is never
split, so attention is split over "model" only where the query
projection is and the query heads divide the axis, else it is whole on
each device of the axis; a recurrence is split as its state.

**HBM bytes**, the traffic a step cannot avoid: the weights each device
computes with (gathered over the data axes, sharded over "model") read
once a forward (train: forward, backward and the gradients written, once
a microbatch, with the float32 accumulator of the device's shard read and
written), the
state's shard read and written by the update, the caches' shard read by
a decode step, and every product's input and output per token (split as
the product is).

**Collective bytes**, ring formulas per device, a group of ``n`` devices
and ``L`` the device's shard of a leaf in bytes:

    FSDP all-gather (each leaf sharded over the data axes)   (n - 1)·L
        once a forward; a train step gathers again for the backward,
        and does both for each microbatch
    gradient reduce-scatter over the leaf's data axes        (n - 1)·L
        once a microbatch
    gradient all-reduce over the data axes it is replicated on
                                                             2·(n - 1)/n·L
        once a step
    tensor-parallel all-reduce of a block's output over "model"
                                        2·(tp - 1)/tp · T·d·itemsize
        T the tokens of a data shard; one after each mixer and each
        dense FFN a forward, as many again in the backward
    all-gather of the q, k, v projections' outputs over "model" where
    attention is whole on each device but the projections are split
                                        (tp - 1)/tp · T·(Hq + 2·Hkv)·dh·itemsize
        (Hkv 0 where K and V are whole)
        a layer a forward, as many again (a reduce-scatter) in the backward
    expert all-to-all (dispatch and combine, E over "model")
                                        2·(tp - 1)/tp · E·R·d·itemsize / tp
        R the capacity rows of a data shard; as many again in the backward

Every term is a prediction from the descriptor's published peaks
(``--device cuda``: the card's ``h100`` descriptor; ``--device cpu``:
``tpu_v5e``, the CPU parity tests' tiles), never a measurement.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k --mesh pod --out experiments/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    (add --device cpu without a card)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import SHAPES, RunConfig, cells, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.hardware import HardwareSpec, query
from repro_torch.core.layout import round_up
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import ABSTRACT_MESHES, axis_sizes, dp_axes
from repro_torch.models.model import build_model
from repro_torch.models.moe import capacity, dispatch_blocks
from repro_torch.obs.attrib import _layer_costs
from repro_torch.roofline.analysis import roofline_terms
from repro_torch.training.optimizer import UPDATE_SLICE, leaves, make_optimizer
from repro_torch.training.train_state import TrainState

__all__ = ["MetaGenerator", "Cell", "build_cell", "cell_counts", "run_cell",
           "serving_cell", "main"]


class MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is the meta device.  The model's
    init draws every leaf with ``device=generator.device``, so through it
    the init builds the parameter tree's paths, shapes and dtypes and
    allocates nothing (drawing from a CPU generator onto meta is allowed)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


@dataclasses.dataclass
class Cell:
    """One cell's model (on meta), its trees and their specs: ``trees``
    and ``specs`` keyed ``state``/``batch`` (train), ``params``/``batch``
    (prefill), ``params``/``caches``/``token``/``pos`` (decode)."""

    model: object
    shape: ShapeSpec
    mesh: object
    trees: dict
    specs: dict


def build_cell(cfg: ModelConfig, shape: ShapeSpec, run: RunConfig, mesh,
               hw: HardwareSpec) -> Cell:
    """The cell's meta trees and specs (``build_lowerable``'s three kinds)."""
    model = build_model(cfg, run, shape, hw=hw, device="meta", mesh=mesh)
    params = model.init(MetaGenerator())
    if shape.kind == "train":
        state = TrainState.create(params, make_optimizer(run))
        if run.grad_compression:
            from repro_torch.training import compression
            state.opt_state["err"] = compression.init_error_buffer(params)
        batch = model.input_specs("train")
        return Cell(model, shape, mesh, {"state": state, "batch": batch},
                    {"state": sharding.state_specs(state, run, mesh),
                     "batch": sharding.batch_specs(batch, mesh)})
    p_specs = sharding.param_specs(params, run, mesh)
    if shape.kind == "prefill":
        batch = model.input_specs("prefill")
        return Cell(model, shape, mesh, {"params": params, "batch": batch},
                    {"params": p_specs, "batch": sharding.batch_specs(batch, mesh)})
    specs = model.input_specs("decode")
    return Cell(model, shape, mesh,
                {"params": params, "caches": specs["caches"],
                 "token": specs["token"], "pos": specs["pos"]},
                {"params": p_specs,
                 "caches": sharding.cache_specs(specs["caches"], mesh, run,
                                                shape.global_batch),
                 "token": sharding.batch_specs(specs["token"], mesh), "pos": ()})


def _model_share(spec: tuple, sizes: dict) -> int:
    """The ways a product's work is split over "model": the axis's size
    where its weight's spec shards a dim over it, else 1 (the product is
    whole on every device of the axis, as where ``sharding._sanitize``
    dropped the axis from a dim it does not divide)."""
    if any("model" in sharding._axes(e) for e in spec):
        return sizes.get("model", 1)
    return 1


def attention_share(cfg: ModelConfig, p_specs, sizes: dict) -> int:
    """The ways attention is split over "model".  A head is never split:
    attention is split where the query projection's output is and the
    query heads divide the axis, else every device of the axis computes
    it whole (SmolLM2's 9 heads on a 4-way axis, as the JAX package's
    compiled step does: each device's attention products carry all 9)."""
    tp = sizes.get("model", 1)
    q = [s for path, s in sharding.tree_paths(p_specs).items()
         if path.endswith("mixer/wq/w")]
    if tp > 1 and q and _model_share(q[0], sizes) == tp and cfg.n_heads % tp == 0:
        return tp
    return 1


def _kv_split(cfg: ModelConfig, tp: int) -> bool:
    """Whether the K and V projections are split over "model": only where
    the KV heads are at least its size (the JAX package's ``kv_tp``,
    ``models/attention.py``); else each device computes them whole."""
    return cfg.n_kv_heads >= tp


def _recurrent_share(cfg: ModelConfig, t: str, tp: int) -> int:
    """The ways a recurrence is split over "model": as its state
    (``sharding.cache_specs``), RWKV-6's heads or mamba's channels, where
    they divide the axis."""
    n = (cfg.d_model // cfg.rwkv_head_dim if t == "rwkv"
         else cfg.mamba_expand * cfg.d_model)
    return tp if n % tp == 0 else 1


def forward_costs(model, kind: str, params, p_specs, mesh) -> dict:
    """A forward over the whole batch, each product divided by the ways
    its work is split over "model" (module docstring): ``flops`` by part,
    ``act_bytes`` (every packed product's input and output, the experts'
    at top_k rows a token) and ``head_share``.  The packed linears, the
    head, the experts and the routers are read off the parameter leaves
    that hold their weights, each split as its own spec says; attention as
    :func:`attention_share`; the recurrences as their state.  On a
    one-device mesh, the whole cell's."""
    cfg, shape = model.cfg, model.shape
    sizes = axis_sizes(mesh)
    tp = sizes.get("model", 1)
    lay = model.ctx.layout(model.compute_dtype)
    m_r, n_r, k_r = lay.m_r, lay.n_r, lay.k_r
    itemsize = model.compute_dtype.itemsize
    b, seq = shape.global_batch, shape.seq_len
    q = 1 if kind == "decode" else seq          # new positions a row
    p = b * q
    logit_rows = seq if kind == "train" else 1
    # the encoder, its frontend, the cross K/V and the vision projection
    # run outside decode
    s_e = seq // cfg.audio_downsample if cfg.family == "encdec" else 0
    vis = cfg.vision_tokens if cfg.family == "vlm" else 0
    whole = kind != "decode"
    # (padded rows, real tokens) of a product, by where its weight sits
    dec_rows = (b * round_up(q, m_r), p)
    enc_rows = (b * round_up(s_e, m_r), b * s_e) if whole else (0, 0)
    vis_rows = (b * round_up(vis, m_r), b * vis) if whole else (0, 0)
    head_rows = b * round_up(logit_rows, m_r)
    moe_rows = 0
    if cfg.n_experts:
        blocks = dispatch_blocks(p, model.ctx)
        moe_rows = round_up(blocks * capacity(p // blocks, cfg), m_r)
    flops = dict.fromkeys(("linear", "head", "moe", "router", "recurrent",
                           "attention"), 0.0)
    act, head_share = 0.0, 1
    flat_s = sharding.tree_paths(p_specs)
    for path, leaf in sharding.tree_paths(params).items():
        share = _model_share(flat_s[path], sizes)
        if path == "lm_head/w" or (path == "embed/e" and cfg.tie_embeddings):
            k, n = leaf.shape if path == "lm_head/w" else leaf.shape[::-1]
            if path == "embed/e":       # gathered over "data", vocab over "model"
                share = tp if n % tp == 0 else 1
            flops["head"] += 2 * head_rows * round_up(k, k_r) * round_up(n, n_r) / share
            head_share = share
            continue
        parent = path.split("/")[-2] if "/" in path else ""
        if not path.endswith("/w") or parent == "dt_proj":
            continue                # norms, biases, mixer vectors; dt_proj
        if parent in ("wk", "wv") and not _kv_split(cfg, tp):
            share = 1
        stacked = "groups/" in path
        lead = leaf.shape[0] if stacked else 1
        mat = tuple(leaf.shape[1:] if stacked else leaf.shape)
        if parent == "router":      # [G, d, E], float32, unpacked
            flops["router"] += 2 * p * lead * mat[0] * mat[1] / share
        elif len(mat) == 3:         # an expert stack [G, E, K, N]
            e, k, n = mat
            flops["moe"] += (2 * moe_rows * lead * e * round_up(k, k_r)
                             * round_up(n, n_r) / share)
            act += cfg.top_k * p * lead * (k + n) * itemsize / share
        else:
            k, n = mat
            if (path.startswith("enc_groups/") or path == "frontend_proj/w"
                    or "/cross/wk/" in path or "/cross/wv/" in path):
                rows, toks = enc_rows
            elif path == "vision_proj/w":
                rows, toks = vis_rows
            else:
                rows, toks = dec_rows
            flops["linear"] += (2 * rows * lead * round_up(k, k_r)
                                * round_up(n, n_r) / share)
            act += toks * lead * (k + n) * itemsize / share
    for i, t in enumerate(cfg.layer_types):
        rec = _layer_costs(cfg, t, itemsize, cfg.moe_on_layer(i))[1]
        if rec:
            flops["recurrent"] += p * rec / _recurrent_share(cfg, t, tp)
    attn = 4 * p * cfg.n_heads * cfg.d_head * seq * cfg.layer_types.count("attn")
    if cfg.family == "encdec":
        attn += 4 * p * cfg.n_heads * cfg.d_head * s_e * cfg.n_layers
        if whole:
            attn += 4 * b * s_e * cfg.n_heads * cfg.d_head * s_e * cfg.encoder_layers
    flops["attention"] = attn / attention_share(cfg, p_specs, sizes)
    return {"flops": flops, "act_bytes": act, "head_share": head_share}


def _without(specs, axes: tuple):
    """Specs with ``axes`` removed (the layout a gather over them leaves)."""
    if isinstance(specs, dict):
        return {k: _without(v, axes) for k, v in specs.items()}
    out = []
    for e in specs:
        kept = tuple(a for a in sharding._axes(e) if a not in axes)
        out.append(sharding._entry(kept))
    return tuple(out)


def _collectives(params, p_specs, mesh, train: bool, micro: int = 1) -> tuple:
    """({FSDP all-gather, gradient reduce-scatter, gradient all-reduce}
    bytes per device, the same ops' counts), over the parameter leaves;
    ``micro`` microbatches each gather and reduce-scatter anew."""
    sizes = axis_sizes(mesh)
    dps = dp_axes(mesh)
    dp_size = math.prod(sizes[a] for a in dps)
    nbytes = {"fsdp_all_gather": 0.0, "grad_reduce_scatter": 0.0,
              "grad_all_reduce": 0.0}
    ops = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    flat_s = sharding.tree_paths(p_specs)
    for path, leaf in sharding.tree_paths(params).items():
        spec = flat_s[path]
        local = (math.prod(sharding.local_shape(leaf.shape, spec, mesh))
                 * leaf.element_size())
        n_s = math.prod(sizes[a] for e in spec for a in sharding._axes(e)
                        if a in dps)
        if n_s > 1:
            nbytes["fsdp_all_gather"] += (n_s - 1) * local * (1 + train) * micro
            ops["all-gather"] += (1 + train) * micro
            if train:
                nbytes["grad_reduce_scatter"] += (n_s - 1) * local * micro
                ops["reduce-scatter"] += micro
        n_r = dp_size // n_s
        if train and n_r > 1:
            nbytes["grad_all_reduce"] += 2 * (n_r - 1) / n_r * local
            ops["all-reduce"] += 1
    return nbytes, ops


def _f32_bytes(tree, specs, mesh) -> int:
    """One device's shards of ``tree``'s tensors under ``specs``, in float32."""
    flat_s = sharding.tree_paths(specs)
    return sum(4 * math.prod(sharding.local_shape(leaf.shape, flat_s[path], mesh))
               for path, leaf in sharding.tree_paths(tree).items())


def cell_counts(cell: Cell) -> dict:
    """Per-device FLOPs (``flops_parts``: a step's, by part), HBM bytes,
    collective bytes by kind, collective counts and memory (module
    docstring)."""
    model, shape, mesh = cell.model, cell.shape, cell.mesh
    cfg, run = model.cfg, model.run
    sizes = axis_sizes(mesh)
    chips = math.prod(sizes.values())
    tp = sizes.get("model", 1)
    dps = dp_axes(mesh)
    dp = math.prod(sizes[a] for a in dps)
    b = shape.global_batch
    dp_eff = dp if b % dp == 0 and b >= dp else 1
    train = shape.kind == "train"
    params = cell.trees["state"].params if train else cell.trees["params"]
    p_specs = cell.specs["state"].params if train else cell.specs["params"]
    costs = forward_costs(model, shape.kind, params, p_specs, mesh)
    passes = (3 + run.remat) if train else 1
    # the tokens' share: a data shard's; attention over every data device
    # (a batch the data axes do not divide is sequence-sharded); the head
    # outside remat
    parts = {k: (3 if train and k == "head" else passes) * v
             / (dp if k == "attention" else dp_eff)
             for k, v in costs["flops"].items()}
    flops = sum(parts.values())

    itemsize = model.compute_dtype.itemsize
    gathered = _without(p_specs, dps)
    w_dev = sharding.device_bytes(params, gathered, mesh)
    p_dev = sharding.device_bytes(params, p_specs, mesh)
    tokens = b * (1 if shape.kind == "decode" else shape.seq_len)
    t_dev = tokens / dp_eff
    act = costs["act_bytes"] / dp_eff
    args = {k: sharding.device_bytes(cell.trees[k], cell.specs[k], mesh)
            for k in cell.trees}
    # float32 logits of the rows a step reads, a data shard's, split as
    # the head's weight is over "model"
    logits = 4 * (t_dev if train else b / dp_eff) * cfg.vocab / costs["head_share"]
    n = max(1, run.microbatch) if train else 1
    if train:
        # microbatches (run.microbatch > 1, training/step.py): each runs
        # the forward and the backward on its slice of the batch, gathers
        # the weights for both, and adds its gradients, reduce-scattered
        # to the parameters' layout, into a float32 accumulator of the
        # device's shard
        acc = _f32_bytes(params, p_specs, mesh) if n > 1 else 0
        # read: the weights in each forward and backward, the state and
        # the gradients by the update; written: the gradients (with the
        # accumulator read and written), the state, the activations (read
        # back by the backward) and the logits
        hbm = (n * (3 * w_dev + 2 * acc) + 2 * args["state"] + p_dev
               + passes * act + 2 * logits)
        # the step's transients: the gradients before their reduce-scatter,
        # the packed weight copies the forward saves, the accumulator, a
        # microbatch's saved activations (with remat, one group's), its
        # logits and their gradient, and the update's float32 temporaries
        # (4 of a slice of UPDATE_SLICE)
        largest = max(leaf.numel() for leaf in leaves(params))
        saved = (act / cfg.n_layers if run.remat else act) / n
        temp = (2 * w_dev + acc + saved + 2 * logits / n
                + 16 * min(largest, UPDATE_SLICE))
    else:
        hbm = w_dev + act + args.get("caches", 0) + logits
        temp = act / (cfg.n_layers + cfg.encoder_layers) + logits
    collective, ops = _collectives(params, p_specs, mesh, train, n)
    per_pass = 2 if train else 1
    # all-reduced block outputs a forward: each mixer, each dense FFN (and
    # arctic's dense branch), whisper's cross-attention and encoder blocks
    n_blocks = (sum(1 + (not cfg.moe_on_layer(i) or cfg.dense_residual)
                    for i in range(cfg.n_layers))
                + (2 * cfg.encoder_layers + cfg.n_layers
                   if cfg.family == "encdec" else 0))
    for k in ("tp_all_reduce", "attention_all_gather", "expert_all_to_all"):
        collective[k] = 0.0
    ops["all-to-all"] = 0
    n_moe = sum(cfg.moe_on_layer(i) for i in range(cfg.n_layers))
    if tp > 1:
        collective["tp_all_reduce"] = (per_pass * n_blocks * 2 * (tp - 1) / tp
                                       * t_dev * cfg.d_model * itemsize)
        ops["all-reduce"] += per_pass * n_blocks
        q_split = [path for path, s in sharding.tree_paths(p_specs).items()
                   if path.endswith("mixer/wq/w") and _model_share(s, sizes) > 1]
        if q_split and attention_share(cfg, p_specs, sizes) == 1:
            # whole heads: the projections' split outputs gathered over
            # "model" before attention (q, k, v of each self-attention;
            # whisper's cross-attention: q, and k, v outside decode)
            hq, hkv = cfg.n_heads, cfg.n_kv_heads * _kv_split(cfg, tp)
            n_self = cfg.layer_types.count("attn")
            elems = n_self * t_dev * (hq + 2 * hkv)
            n_gathers = n_self
            if cfg.family == "encdec":
                te = (b * (shape.seq_len // cfg.audio_downsample) / dp_eff
                      if shape.kind != "decode" else 0)
                elems += (cfg.encoder_layers * te * (hq + 2 * hkv)
                          + cfg.n_layers * (t_dev * hq + te * 2 * hkv))
                n_gathers += cfg.n_layers + (cfg.encoder_layers if te else 0)
            collective["attention_all_gather"] = (
                per_pass * (tp - 1) / tp * elems * cfg.d_head * itemsize)
            ops["all-gather"] += n_gathers
            ops["reduce-scatter"] += n_gathers * train
        if n_moe:
            blocks = dispatch_blocks(tokens, model.ctx)
            rows = blocks * capacity(tokens // blocks, cfg) / dp_eff
            collective["expert_all_to_all"] = (
                per_pass * n_moe * 2 * (tp - 1) / tp
                * cfg.n_experts * rows * cfg.d_model * itemsize / tp)
            ops["all-to-all"] = per_pass * n_moe * 2
    held = sum(args.values())
    memory = {"argument_bytes": held, "temp_bytes": temp,
              "peak_bytes": held + temp,
              **{f"{k}_bytes": v for k, v in args.items()}}
    return {"flops": flops, "hbm_bytes": hbm, "collective": collective,
            "op_counts": ops, "memory": memory, "chips": chips,
            "flops_parts": parts}


def _hw_record(hw: HardwareSpec) -> dict:
    return {k: getattr(hw, k) for k in ("name", "device_name", "flops_bf16",
                                        "flops_f32", "hbm_bw", "ici_bw")}


def run_cell(arch: str, shape_name: str, mesh_name: str, run: RunConfig,
             out_dir: Optional[str] = None, verbose: bool = True, *,
             hw: Optional[HardwareSpec] = None, mesh=None,
             cfg: Optional[ModelConfig] = None) -> dict:
    """Price one cell: ``mesh`` (default ``ABSTRACT_MESHES[mesh_name]``),
    ``hw`` (default the card's descriptor: ``query("cuda")``), ``cfg``
    (default the arch's published config)."""
    t0 = time.perf_counter()
    hw = hw if hw is not None else query("cuda")
    mesh = mesh if mesh is not None else ABSTRACT_MESHES[mesh_name]
    cfg = cfg if cfg is not None else get_config(arch)
    cell = build_cell(cfg, SHAPES[shape_name], run, mesh, hw)
    c = cell_counts(cell)
    report = roofline_terms(
        arch=arch, shape_spec=SHAPES[shape_name], mesh_name=mesh_name,
        chips=c["chips"], cfg=cfg, hw=hw, flops=c["flops"],
        hbm_bytes=c["hbm_bytes"], collective=c["collective"],
        op_counts=c["op_counts"], compute_dtype=run.compute_dtype,
        memory_stats=c["memory"])
    rec = report.to_dict()
    counts = cfg.param_counts()
    rec.update({"status": "ok", "prediction": True, "hw": _hw_record(hw),
                "build_s": round(time.perf_counter() - t0, 3),
                "policy": run.layout_policy, "fsdp": run.fsdp, "microbatch": run.microbatch,
                "params_total": counts["total"], "params_active": counts["active"],
                "flops_parts": c["flops_parts"]})
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ({c['chips']} "
              f"devices): OK, predicted from {hw.device_name or hw.name}'s "
              f"published peaks: compute {report.compute_s * 1e3:.1f}ms  "
              f"memory {report.memory_s * 1e3:.1f}ms  collective "
              f"{report.collective_s * 1e3:.1f}ms  -> {report.bottleneck}-bound  "
              f"roofline {report.roofline_fraction:.2f}  held "
              f"{c['memory']['argument_bytes'] / 2**30:.2f} GiB a device")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{mesh_name}_{run.layout_policy}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def serving_cell(arch: str, run: RunConfig, *, slots: int = 4,
                 max_len: int = 2048, page_tokens: int = 16,
                 chunk_tokens: int = 64, spec_tokens: Optional[int] = None,
                 out_dir: Optional[str] = None, verbose: bool = True,
                 hw: Optional[HardwareSpec] = None,
                 cfg: Optional[ModelConfig] = None) -> dict:
    """The flat paged decode step's predicted cost before launch: an
    engine over meta parameters (nothing allocated) with the real paged
    cache geometry, each flat ladder width priced by the warmup cost model
    (:func:`repro_torch.obs.attrib.build_cost_model`), plus the KV-page
    gather bytes per token and the block table's gather bytes (rows x
    max_pages x 4 B int32 indices)."""
    from repro_torch.obs.attrib import build_cost_model, kv_page_bytes_per_token
    from repro_torch.serving.engine import Engine

    t0 = time.perf_counter()
    hw = hw if hw is not None else query("cuda")
    cfg = cfg if cfg is not None else get_config(arch)
    shape = ShapeSpec("serve_dryrun", max_len, slots, "decode")
    model = build_model(cfg, run, shape, hw=hw, device="meta")
    eng = Engine(model, model.init(MetaGenerator()), device="meta",
                 prepack=False, max_slots=slots, page_tokens=page_tokens,
                 chunk_tokens=chunk_tokens, spec_tokens=spec_tokens)
    cm = build_cost_model(eng, hw=hw)
    kv_tok = kv_page_bytes_per_token(eng.caches, eng.pool.num_pages,
                                     eng.pool.page_tokens)
    bt_bytes = eng.slots * eng.max_pages * 4
    rec = {"status": "ok", "prediction": True, "arch": arch,
           "kind": "serving-flat", "slots": slots, "max_len": max_len,
           "page_tokens": eng.pool.page_tokens, "num_pages": eng.pool.num_pages,
           "chunk_tokens": eng.chunk_tokens, "token_budget": eng.token_budget,
           "spec_tokens": spec_tokens, "kv_bytes_per_token": kv_tok,
           "block_table_gather_bytes": bt_bytes,
           "block_table_gather_s": bt_bytes / hw.hbm_bw,
           "cost_model": cm.to_dict(), "hw": _hw_record(hw),
           "build_s": round(time.perf_counter() - t0, 3)}
    if verbose:
        print(f"[dryrun] {arch} serving flat step ({slots} slots, max_len "
              f"{max_len}, pages {eng.pool.num_pages} x {eng.pool.page_tokens}t, "
              f"KV {kv_tok:.0f} B/token, block-table gather {bt_bytes} B/step), "
              f"predicted from {hw.device_name or hw.name}'s published peaks:")
        for label in sorted(cm.families):
            fc = cm.families[label]
            print(f"  {label:>18}: predicted {fc.predicted_s * 1e6:8.1f}us "
                  f"({fc.bottleneck}-bound)  KV gather "
                  f"{fc.kv_gather_bytes / 2 ** 20:7.2f} MiB "
                  f"({fc.kv_gather_s * 1e6:7.1f}us at {hw.hbm_bw / 1e9:.0f} GB/s)")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{arch}_serving_flat.json"), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--policy", default="scalable",
                    choices=["scalable", "fixed", "unpacked"])
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--microbatch", type=int, default=8,
                    help="a train cell's microbatches (prices its transients, "
                         "weight reads and float32 accumulator)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--device", default="cuda",
                    help="whose descriptor prices the cells: cuda (the card's "
                         "h100) or cpu (tpu_v5e); nothing is allocated on it")
    ap.add_argument("--serving", action="store_true",
                    help="dry-run the flat paged decode step instead of the "
                         "distributed train/prefill/decode cells")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--chunk-tokens", type=int, default=64)
    ap.add_argument("--spec-tokens", type=int, default=None)
    args = ap.parse_args(argv)

    hw = query(args.device)
    run = RunConfig(layout_policy=args.policy, fsdp=not args.no_fsdp,
                    microbatch=args.microbatch)
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    if args.serving:
        if not args.arch:
            raise SystemExit("--serving needs --arch")
        serving_cell(args.arch, run, slots=args.slots, max_len=args.max_len,
                     page_tokens=args.page_tokens, chunk_tokens=args.chunk_tokens,
                     spec_tokens=args.spec_tokens, out_dir=args.out, hw=hw)
        return

    if args.all:
        todo = [(a, s) for a, s, ok, _ in cells() if ok]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        raise SystemExit("--arch/--shape or --all")

    failures = []
    for arch, shape in todo:
        for mesh_name in meshes:
            try:
                run_cell(arch, shape, mesh_name, run, out_dir=args.out, hw=hw)
            except Exception as e:  # a failure here is a sharding bug
                failures.append((arch, shape, mesh_name, repr(e)))
                print(f"[dryrun] {arch} x {shape} x {mesh_name}: FAIL {e}")
                traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} dry-run cells failed: {failures}")
    print(f"[dryrun] all {len(todo) * len(meshes)} cells priced OK")


if __name__ == "__main__":
    main()
