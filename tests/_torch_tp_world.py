"""One rank of a CPU world (gloo, ``FileStore``) serving across ranks, for
``test_torch_tp_serving.py``; and what the test and the world share: the
widened reduced SmolLM2, the request trace, the step families.  Imports
no JAX.

    python tests/_torch_tp_world.py RANK WORLD STORE PARAMS.npz OUT

Each rank loads the same parameters (``PARAMS.npz``, the JAX package's
tree flattened by ``/``), builds the model on a ``("data", "model") =
(1, WORLD)`` mesh and writes ``OUT.<rank>.pt``: per step family the
tokens, finish reasons and every model call's logits of its drains, the
local shapes of its weights and pools, and the checks made inside the
world (a biased, activated row-parallel linear; the page copy by owner; a
drain whose pages all sit on rank 0)."""

import dataclasses
import sys

import numpy as np
import torch

from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")
# 18 pages: split over 2 ranks (9 each) and over 3 (6 each), as cache_specs
# shard the page dim; a tight pool, so the drains preempt and use every rank
NUM_PAGES = 18
ENGINE = dict(max_slots=3, page_tokens=8, num_pages=NUM_PAGES)
FAMILIES = {"flat": dict(chunk_tokens=16, token_budget=24),
            "dense": dict(chunk_tokens=16, flat=False),
            "monolithic": {}}
TEMPERATURES = (1.0, 0.7, 0.0, 1.3, 0.9)


def widened(cfg):
    """The reduced config widened so that tiles split across ranks: Q and
    O over 3 tiles of 128, K/V over 2, the MLP over 8 (reduced SmolLM2 is
    d_model 64 with one KV head: one tile, whole on every rank)."""
    return dataclasses.replace(cfg, d_model=384, n_heads=6, n_kv_heads=3,
                               d_head=64, d_ff=1024)


def config():
    return widened(reduced_config(get_config("smollm2-135m"), layers=2))


def trace(vocab: int, seed: int = 0):
    """Five requests of 20-44 prompt tokens and 4-9 new: more pages than
    the pool holds at once, so pages land on every rank and rows preempt."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(n)).astype(np.int32), int(k))
            for n, k in zip(rng.integers(20, 45, 5), rng.integers(4, 10, 5))]


def short_trace(vocab: int, seed: int = 1):
    """Two short requests: with a 64-page pool every page sits on rank 0."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32), 4) for n in (5, 9)]


def unflatten(flat: dict) -> dict:
    out = {}
    for key, value in flat.items():
        node = out
        *head, last = key.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = value
    return out


def load_params(path: str, mesh=None) -> dict:
    """The parameters, whole, or with ``mesh`` this rank's shard of them
    (``from_jax_params(..., mesh=)``)."""
    from repro_torch.weights import from_jax_params
    with np.load(path) as z:
        tree = unflatten({k: z[k] for k in z.files})
    if mesh is None:
        return from_jax_params(tree)
    from repro_torch.core.hardware import query
    from repro_torch.core.layout import make_layout
    return from_jax_params(tree, mesh=mesh, run=RunConfig(**F32),
                           layout_of=lambda dt: make_layout("scalable",
                                                            query("cpu"), dt))


def _live(name, out, a):
    """The rows of a model call's logits the engine reads: those of the
    rows the call carries tokens for (an inert row's are not read)."""
    if name == "_run_paged":                  # [B, K, V]; counts is a[3]
        return out[np.asarray(a[3]) > 0]
    row_ids = np.asarray(a[2])                # flat: [slots * k1, V]
    k1 = out.shape[0] // a[1].shape[0]
    slots = np.unique(row_ids[row_ids >= 0])
    return out.reshape(a[1].shape[0], k1, -1)[slots]


def drain(eng, reqs, greedy=True):
    """(tokens by request, finish reasons, every model call's logits at
    the rows it carries)."""
    calls = []
    for name in ("_run_flat", "_run_paged"):
        run = getattr(eng, name)

        def rec(*a, _run=run, _name=name, **k):
            out = _run(*a, **k)
            calls.append(_live(_name, np.array(out), a))
            return out
        setattr(eng, name, rec)
    rids = [eng.add_request(p, k, temperature=TEMPERATURES[i % 5], seed=7)
            for i, (p, k) in enumerate(reqs)]
    fin = {r.rid: r for r in eng.drain(greedy=greedy, seed=3)}
    return ([list(fin[r].out_tokens) for r in rids],
            [fin[r].finish_reason for r in rids], calls)


def serve(params, mesh=None, families=FAMILIES, sampled=("flat",),
          shard=None):
    """Every family's greedy drain of :func:`trace` (and the flat one
    sampled) on an engine over ``mesh`` (None: one rank); ``shard``: the
    rank's shard of the parameters, which the dense chunked family's
    engine is given instead of the whole tree."""
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = config()
    out = {}
    for fam, kw in families.items():
        for greedy in (True, False) if fam in sampled else (True,):
            m = build_model(cfg, RunConfig(**F32), ShapeSpec(*SHAPE),
                            device="cpu", mesh=mesh)
            given = shard if shard is not None and fam == "dense" else params
            eng = Engine(m, given, device="cpu", mesh=mesh, **ENGINE, **kw)
            before = 0 if m.ctx.tp is None else m.ctx.tp.calls
            toks, reasons, calls = drain(eng, trace(cfg.vocab), greedy)
            out[f"{fam} {'greedy' if greedy else 'sampled'}"] = {
                "tokens": toks, "reasons": reasons, "logits": calls,
                "preemptions": eng.num_preemptions,
                "captures": eng.stats()["captures"],
                "collectives": (0 if m.ctx.tp is None else m.ctx.tp.calls - before,
                                len(calls)),
                "sanitized": 0 if eng.sanitizer is None
                else eng.sanitizer.rank_writes}
            if mesh is not None and fam == "flat" and greedy:
                out["shapes"] = {
                    "params": {k: tuple(v.shape) if isinstance(v, torch.Tensor)
                               else v for k, v in _paths(eng.params).items()},
                    "pool": tuple(eng.caches["p0"]["kv"]["k_pages"].shape),
                    "kv_shard": eng.kv_shard}
    return out


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_paths(v, key))
        else:
            out[key] = v
    return out


def row_parallel_check(mesh, rank: int):
    """A biased linear with a tanh-GELU epilogue, split row-parallel over
    the ranks, against the whole product on one rank, and against an
    epilogue applied to each rank's partial before the sum (which the
    product must not do)."""
    from repro_torch.core.hardware import query
    from repro_torch.core.layout import LayoutPolicy
    from repro_torch.core.linear import MatmulContext, linear_apply, prepack_params
    from repro_torch.distributed import sharding
    from repro_torch.distributed.comm import ModelAxis
    from repro_torch.kernels.mmt4d.ref import ACTIVATIONS
    g = torch.Generator().manual_seed(5)
    k, n = 700, 300                    # 6 K tiles: 3 and 3, or 2, 2 and 2
    w = torch.randn((k, n), generator=g) * k ** -0.5
    b = torch.randn((n,), generator=g)
    x = torch.randn((1, 20, k), generator=g)
    hw = query("cpu")
    ctx1 = MatmulContext(policy=LayoutPolicy.SCALABLE, hw=hw)
    ctx = dataclasses.replace(ctx1, mesh_axes=("data", "model"),
                              tp_size=mesh.size(), tp=ModelAxis.of(mesh))
    whole = {"w": w, "b": b}
    want = linear_apply(prepack_params(whole, ctx1), x, ctx1, activation="gelu")
    shard = sharding.shard_params({"wd": whole}, {"wd": {"w": ("model", None),
                                                         "b": (None,)}},
                                  mesh, sharding.mesh_coord(mesh), ctx.layout)
    got = linear_apply(prepack_params(shard, ctx)["wd"], x, ctx,
                       activation="gelu", tp="row")
    lo, hi = shard["wd"]["w_split"][1:3]
    part = x[..., lo * 128:hi * 128] @ w[lo * 128:hi * 128]
    wrong = ctx.tp.sum_(ACTIVATIONS["gelu"](part + b))
    return {"err": float((got - want).abs().max()),
            "wrong_err": float((wrong - want).abs().max()),
            "split": shard["wd"]["w_split"], "rank": rank}


def copy_check(mesh):
    """copy_pages by owner: each page of a page-split pool copied onto a
    page of another rank, and onto its own rank, against the same copies
    in one whole pool."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.comm import ModelAxis
    from repro_torch.serving.kv_cache import copy_pages
    axis = ModelAxis.of(mesh)
    g = torch.Generator().manual_seed(9)
    whole = {"p0": {"kv": {"k_pages": torch.randn((2, NUM_PAGES, 8, 3, 64), generator=g),
                           "v_pages": torch.randn((2, NUM_PAGES, 8, 3, 64), generator=g)}}}
    lo, hi = sharding.unit_range(NUM_PAGES, "model", mesh, sharding.mesh_coord(mesh))
    local = {"p0": {"kv": {k: torch.cat([v[:, lo:hi], torch.zeros_like(v[:, :1])], 1)
                           for k, v in whole["p0"]["kv"].items()}}}
    for src, dst in ((1, NUM_PAGES - 1), (NUM_PAGES - 2, 2), (3, 4)):
        s, d = torch.tensor([src]), torch.tensor([dst])
        copy_pages(whole, s, d)
        copy_pages(local, s, d, kv_shard=(lo, hi - lo), axis=axis)
    return all(torch.equal(local["p0"]["kv"][k][:, :hi - lo],
                           whole["p0"]["kv"][k][:, lo:hi]) for k in ("k_pages", "v_pages"))


def rank0_pages(params, mesh):
    """A drain of :func:`short_trace` over a 64-page pool, whose pages all
    sit on rank 0: its tokens and logits, and whether any of the rank's
    pages (its trash slot aside) was written."""
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    cfg = config()
    m = build_model(cfg, RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu", mesh=mesh)
    eng = Engine(m, params, device="cpu", mesh=mesh, max_slots=3, page_tokens=8,
                 num_pages=64, chunk_tokens=16)
    toks, _, calls = drain(eng, short_trace(cfg.vocab))
    kp = eng.caches["p0"]["kv"]["k_pages"]
    return {"tokens": toks, "logits": calls, "kv_shard": eng.kv_shard,
            "written": bool((kp[:, :-1] != 0).any())}


def main(rank: int, world: int, store: str, params_path: str, out: str):
    import torch.distributed as dist
    from repro_torch.distributed.comm import pick_backend
    from repro_torch.launch.mesh import make_elastic_mesh
    torch.set_num_threads(1)
    dist.init_process_group(pick_backend("cpu", world),
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        # every rank on the model axis: ("data", "model") = (1, world)
        mesh = make_elastic_mesh(model_parallel=world, device_type="cpu")
        params = load_params(params_path)
        served = serve(params, mesh, shard=load_params(params_path, mesh))
        res = {"serve": served,
               "sanitized": sum(v["sanitized"] for k, v in served.items()
                                if k != "shapes"),
               "row_parallel": row_parallel_check(mesh, rank),
               "copy_by_owner": copy_check(mesh),
               "rank0_pages": rank0_pages(params, mesh)}
        torch.save(res, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
