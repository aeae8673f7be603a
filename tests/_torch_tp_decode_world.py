"""One rank of a CPU world (gloo, ``FileStore``) running the dense-cache
decode step across ranks, for ``test_torch_tp_decode.py``; and what the
test, the world and the JAX package's run share: the models, the cases,
the calls and their inputs.  Imports no JAX.

    python tests/_torch_tp_decode_world.py RANK WORLD STORE DIR OUT

Each rank loads each model's parameters (``DIR/<arch>.npz``, the JAX
package's tree flattened by ``/``), and for each case of its world
(:data:`CASES`) builds the model on the case's ``("data", "model")``
mesh, takes its shard of the parameters (``from_jax_params(mesh=)``),
makes its windows of the caches (``prefill_cache``) and runs the case's
calls (:func:`calls`) through ``decode_step``.  It writes
``OUT.<rank>.pt``: per case the rank's coordinate, its rows, the logits
of every call, its windows of the caches after the last call and the
collectives made; the prefill cell's ``forward(last_only=True)``; and
``Engine(mesh=(1, WORLD)).generate_static``'s tokens, greedy and
sampled."""

import sys

import numpy as np
import torch

import _torch_tp_world as W
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config

SEQ = 64                    # (2, 2) at batch 1: 4 windows of 16 positions
PROMPT = 48                 # the prefill crosses the windows' edges at 16 and 32
DECODE = 4                  # decode steps: positions 48 .. 51, the last window
CLAMP = (62, 4)             # 4 tokens at 62: the write clamped to 60 .. 63
SHAPE = ("serve", SEQ, 4, "decode")
F32 = W.F32
ARCHS = ("smollm2-135m", "whisper-small", "internvl2-26b")
# (name, arch, (data, model), batch, run config fields over F32)
CASES = (("(1, 2) b4", "smollm2-135m", (1, 2), 4, {}),
         ("(1, 2) b1", "smollm2-135m", (1, 2), 1, {}),
         ("(2, 1) b4", "smollm2-135m", (2, 1), 4, {}),
         ("(2, 1) b1", "smollm2-135m", (2, 1), 1, {}),
         ("(2, 1) b3", "smollm2-135m", (2, 1), 3, {}),
         ("(2, 2) b4", "smollm2-135m", (2, 2), 4, {}),
         ("(2, 2) b1", "smollm2-135m", (2, 2), 1, {}),
         ("(2, 2) b4 fsdp off", "smollm2-135m", (2, 2), 4, dict(fsdp=False)),
         ("whisper (2, 2) b4", "whisper-small", (2, 2), 4, {}),
         ("whisper (2, 2) b1", "whisper-small", (2, 2), 1, {}),
         ("internvl2 (2, 2) b4", "internvl2-26b", (2, 2), 4, {}),
         ("internvl2 (2, 2) b1", "internvl2-26b", (2, 2), 1, {}))
# the cases that also make the clamped call (its write in a window of
# 32, of 16, and of whisper's 16 with cross K/V windows of 4)
CLAMPED = ("(2, 1) b3", "(2, 2) b1", "whisper (2, 2) b1")
# generate_static on (1, R): a batch of 2 prompts of GEN_PROMPT tokens,
# whose new tokens reach the last of (1, 4)'s windows of 16
GEN_BATCH, GEN_PROMPT, GEN_NEW = 2, 44, 12
TEMPERATURE_SEED = 5


def world_of(dims) -> int:
    return dims[0] * dims[1]


def config(arch: str):
    """``arch`` reduced to 2 layers and widened so that tiles split across
    ranks (``_torch_tp_world.widened``)."""
    return W.widened(reduced_config(get_config(arch), layers=2))


def run_fields(case: str) -> dict:
    return {**F32, **next(c[4] for c in CASES if c[0] == case)}


def inputs(arch: str, batch: int, seed: int = 0) -> dict:
    """The case's inputs, numpy, the same in both packages: the prompt
    tokens [B, PROMPT] (vlm: PROMPT less its patches), the tokens of the
    decode steps [B, DECODE] and of the clamped call [B, 4]; whisper's
    frames [B, SEQ / 4, d], the vlm's patches [B, vision_tokens, d]."""
    cfg = config(arch)
    rng = np.random.default_rng(seed + batch)
    plen = PROMPT - (cfg.vision_tokens if cfg.family == "vlm" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, plen)).astype(np.int32),
           "decode": rng.integers(0, cfg.vocab, (batch, DECODE)).astype(np.int32),
           "clamp": rng.integers(0, cfg.vocab, (batch, CLAMP[1])).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, SEQ // cfg.audio_downsample, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (batch, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def calls(arch: str, batch: int, clamp: bool = False) -> list:
    """The case's calls of ``decode_step``: (label, tokens [B, s], pos,
    whether the tokens' embeddings are the vlm prefill's): the prefill at
    0, the decode steps and with ``clamp`` the clamped call."""
    x = inputs(arch, batch)
    vlm = config(arch).family == "vlm"
    out = [("prefill", np.zeros((batch, PROMPT), np.int32) if vlm else x["tokens"],
            0, vlm)]
    out += [(f"decode {i}", x["decode"][:, i:i + 1], PROMPT + i, False)
            for i in range(DECODE)]
    if clamp:
        out.append(("clamp", x["clamp"], CLAMP[0], False))
    return out


def gen_prompts(vocab: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, vocab, (GEN_BATCH, GEN_PROMPT)).astype(np.int32)


def load(arch: str, d: str) -> dict:
    with np.load(f"{d}/{arch}.npz") as z:
        return W.unflatten({k: z[k] for k in z.files})


def build(arch: str, run: RunConfig, mesh=None, device="cpu"):
    from repro_torch.models.model import build_model
    return build_model(config(arch), run, ShapeSpec(*SHAPE), device=device,
                       mesh=mesh)


def run_calls(model, params, arch: str, batch: int, clamp: bool = False) -> tuple:
    """Every call of :func:`calls` through ``decode_step`` on caches made
    by ``prefill_cache``: (logits of each call, the caches)."""
    x = inputs(arch, batch)
    caches = model.prefill_cache(params, x)
    embeds = None
    if model.cfg.family == "vlm":
        embeds = model._embeds(model.gather_shards(params), x)
    logits = []
    with torch.no_grad():
        for _, tok, pos, pre in calls(arch, batch, clamp):
            out, caches = model.decode_step(
                params, caches, torch.as_tensor(tok),
                torch.tensor(pos, dtype=torch.int32),
                embeds if pre else None)
            logits.append(out.clone())
    return logits, caches


def plain(tree):
    """A cache tree as plain dicts of tensors (a RankCaches' window left
    out)."""
    if isinstance(tree, dict):
        return {k: plain(v) for k, v in tree.items()}
    return tree.clone()


def case_run(case: str, mesh, d: str) -> dict:
    from repro_torch.weights import from_jax_params
    _, arch, _, batch, _ = next(c for c in CASES if c[0] == case)
    run = RunConfig(**run_fields(case))
    model = build(arch, run, mesh)
    params = from_jax_params(load(arch, d), mesh=mesh, run=run,
                             layout_of=model.ctx.layout)
    logits, caches = run_calls(model, params, arch, batch, case in CLAMPED)
    win = caches.window
    return {"coord": tuple(mesh.get_coordinate()), "rows": win.rows,
            "seq": None if win.seq is None else (win.seq.lo, win.seq.axis.size),
            "cross": None if win.cross is None else (win.cross.lo,
                                                     win.cross.axis.size),
            "logits": logits, "caches": plain(caches),
            "collectives": sum(a.calls for a in model.rank_axes)}


def prefill_cell(mesh, d: str) -> dict:
    """The reference's prefill cell on the (2, 2) mesh:
    ``forward(last_only=True)`` of the prompts of case "(2, 2) b4" over
    the rank's batch rows (``batch_specs``), from the initial shards."""
    from repro_torch.weights import from_jax_params
    run = RunConfig(**F32)
    model = build("smollm2-135m", run, mesh)
    params = from_jax_params(load("smollm2-135m", d), mesh=mesh, run=run,
                             layout_of=model.ctx.layout)
    dp = model.ctx.dp
    tokens = inputs("smollm2-135m", 4)["tokens"]
    rows = slice(dp.rank * 4 // dp.size, (dp.rank + 1) * 4 // dp.size)
    with torch.no_grad():
        logits, _ = model.forward(params, {"tokens": tokens[rows]}, last_only=True)
    return {"rows": (rows.start, rows.stop), "logits": logits}


def generate(mesh, d: str) -> dict:
    """``Engine(mesh=).generate_static`` of :func:`gen_prompts` on a (1, R)
    mesh, greedy and sampled, on one engine."""
    from repro_torch.serving.engine import Engine
    run = RunConfig(**F32)
    model = build("smollm2-135m", run, mesh)
    eng = Engine(model, W.load_params(f"{d}/smollm2-135m.npz"), device="cpu",
                 mesh=mesh, max_slots=GEN_BATCH, page_tokens=8)
    batch = {"tokens": gen_prompts(model.cfg.vocab)}
    out = {"greedy": eng.generate_static(batch, GEN_NEW),
           "sampled": eng.generate_static(batch, GEN_NEW, greedy=False,
                                          seed=TEMPERATURE_SEED)}
    out["collectives"] = model.ctx.tp.calls
    return out


def main(rank: int, world: int, store: str, d: str, out: str):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        res = {}
        meshes = {}

        def mesh_of(dims):
            if dims not in meshes:
                meshes[dims] = init_device_mesh("cpu", dims,
                                                mesh_dim_names=("data", "model"))
            return meshes[dims]

        for case, _, dims, _, _ in CASES:
            if world_of(dims) == world:
                res[case] = case_run(case, mesh_of(dims), d)
        if world == 4:
            res["prefill cell"] = prefill_cell(mesh_of((2, 2)), d)
        res["generate"] = generate(mesh_of((1, world)), d)
        torch.save(res, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
