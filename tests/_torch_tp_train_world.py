"""One rank of a CPU world (gloo, ``FileStore``) training across ranks, for
``test_torch_tp_train.py``; and what the test and the world share: the
runs (mesh, run config, steps), the batches, the state's files.  Imports
no JAX.

    python tests/_torch_tp_train_world.py RANK WORLD STORE STATE.npz OUT

Each rank loads the JAX package's train state (``STATE.npz``: the
parameters under ``params/`` and the optimizer state under ``opt/``,
flattened by ``/``), and for each run of its world (:data:`RUNS`) builds
the widened reduced SmolLM2 (``_torch_tp_world.config``) on the run's
``("data", "model")`` mesh, takes its shard of the state with
``from_jax_state(mesh=)`` and trains it ``steps`` steps on the global
batches (:func:`batches`).  It writes ``OUT.<rank>.pt``: per run the
rank's coordinate, its shard of the state before the first step and
after each, its gradients at the first step, each step's metrics, the
collectives a step, and for the main run the last position's logits of
``forward(last_only=True)`` over its batch shard."""

import sys

import numpy as np
import torch

import _torch_tp_world as W
from repro_torch.configs import RunConfig, ShapeSpec

SEQ, BATCH, STEPS = 32, 4, 3
SHAPE = ("train", SEQ, BATCH, "train")
F32 = dict(W.F32, warmup_steps=1)
# (name, (data, model), world, run config over F32, steps)
RUNS = (("(1, 2)", (1, 2), 2, dict(fsdp=True), STEPS),
        ("(2, 1)", (2, 1), 2, dict(fsdp=True), STEPS),
        ("(2, 2)", (2, 2), 4, dict(fsdp=True), STEPS),
        ("(2, 2) fsdp off", (2, 2), 4, dict(fsdp=False), STEPS),
        ("(2, 2) remat", (2, 2), 4, dict(fsdp=True, remat=True), 1),
        ("(2, 2) 8-bit", (2, 2), 4, dict(fsdp=True, adam_8bit=True), 2),
        ("(2, 2) compression", (2, 2), 4, dict(fsdp=True, grad_compression=True), 1),
        ("(2, 2) microbatch 2", (2, 2), 4, dict(fsdp=True, microbatch=2), 1),
        # past 512 positions: chunked_attention, as on one rank
        ("(1, 2) seq 1024", (1, 2), 2, dict(fsdp=True, seq=1024, batch=1), 1))
MAIN = "(2, 2)"


def _extra(name: str) -> dict:
    return dict(next(r[3] for r in RUNS if r[0] == name))


def run_fields(name: str) -> dict:
    """Run ``name``'s ``RunConfig`` fields, the same in both packages."""
    extra = _extra(name)
    extra.pop("seq", None), extra.pop("batch", None)
    return {**F32, **extra}


def run_config(name: str) -> RunConfig:
    return RunConfig(**run_fields(name))


def batches(vocab: int, name: str = MAIN, seed: int = 0) -> list:
    """The global batches of run ``name``, one a step: tokens and
    next-token labels."""
    extra = _extra(name)
    seq, batch = extra.get("seq", SEQ), extra.get("batch", BATCH)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        t = rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def shape(name: str = MAIN) -> ShapeSpec:
    extra = _extra(name)
    return ShapeSpec("train", extra.get("seq", SEQ), extra.get("batch", BATCH),
                     "train")


def load_state(path: str, with_err: bool = False):
    """(step, params, opt_state) as numpy trees from ``STATE.npz``; with
    ``with_err`` an error buffer of zeros beside the moments."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    params = W.unflatten({k[7:]: v for k, v in flat.items() if k.startswith("params/")})
    opt = W.unflatten({k[4:]: v for k, v in flat.items() if k.startswith("opt/")})
    if with_err:
        opt["err"] = W.unflatten({k[7:]: np.zeros(v.shape, np.float32)
                                  for k, v in flat.items() if k.startswith("params/")})
    return int(flat["step"]), params, opt


def layout_of(dtype):
    from repro_torch.core.hardware import query
    from repro_torch.core.layout import make_layout
    return make_layout("scalable", query("cpu"), dtype)


def eightbit_opt(opt_np: dict, params_np: dict) -> dict:
    """The 8-bit AdamW's initial state (zero moments) as numpy trees."""
    from repro_torch.training.optimizer import AdamW, tree_map
    from repro_torch.weights import from_jax_params
    st = AdamW(eightbit=True).init(from_jax_params(params_np))
    return tree_map(lambda t: t.numpy(), st)


def train(name: str, mesh, state_path: str) -> dict:
    from repro_torch.distributed import sharding
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.step import make_train_step
    from repro_torch.weights import from_jax_state
    run = run_config(name)
    steps = next(r[4] for r in RUNS if r[0] == name)
    cfg = W.config()
    model = build_model(cfg, run, shape(name), device="cpu", mesh=mesh)
    step0, params_np, opt_np = load_state(state_path, run.grad_compression)
    if run.adam_8bit:
        opt_np = eightbit_opt(opt_np, params_np)
    state = from_jax_state(step0, params_np, opt_np, mesh=mesh, run=run,
                           layout_of=model.ctx.layout)
    clone = lambda tree: _tree(tree, lambda t: t.clone())    # noqa: E731
    out = {"coord": tuple(mesh.get_coordinate()),
           "before": {"params": clone(state.params), "opt": clone(state.opt_state)},
           "steps": []}
    fn = make_train_step(model, make_optimizer(run, 10), run)
    bs = batches(cfg.vocab, name)
    grads, _ = fn.grads_of(state.params, bs[0])
    out["grads"] = _tree(grads, lambda t: t.clone())
    axes = [a for a in (model.ctx.dp, model.ctx.tp) if a is not None]
    for i in range(steps):
        before = sum(a.calls for a in axes), sum(a.bytes for a in axes)
        state, met = fn(state, bs[i])
        out["steps"].append({
            "metrics": {k: float(v) for k, v in met.items()},
            "collectives": sum(a.calls for a in axes) - before[0],
            "bytes": sum(a.bytes for a in axes) - before[1],
            "params": clone(state.params), "opt": clone(state.opt_state)})
    if name == MAIN:
        dp = model.ctx.dp
        rows = slice(dp.rank * BATCH // dp.size, (dp.rank + 1) * BATCH // dp.size)
        with torch.no_grad():
            logits, _ = model.forward(state.params,
                                      {"tokens": bs[0]["tokens"][rows]},
                                      last_only=True)
        out["last_only"] = {"rows": (rows.start, rows.stop), "logits": logits}
        out["fsdp_cuts"] = model.fsdp_cuts()
        out["local_shapes"] = {p: tuple(t.shape) for p, t in
                               sharding.tree_paths(state.params).items()
                               if isinstance(t, torch.Tensor)}
    return out


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def main(rank: int, world: int, store: str, state_path: str, out: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = {}
        for name, dims, w, _, _ in RUNS:
            if w != world:
                continue
            mesh = init_device_mesh("cpu", dims, mesh_dim_names=("data", "model"))
            res[name] = train(name, mesh, state_path)
        torch.save(res, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
