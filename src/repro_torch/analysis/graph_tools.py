"""Graph walking for the analysis passes: the JAX package's
``analysis/jaxpr_tools.py`` on the aten graph of a traced step.

PyTorch's counterpart of a jaxpr is the graph ``make_fx`` records.  Three
capabilities, all pure functions of a ``torch.fx.GraphModule``:

* :func:`trace_step` — trace a step with fake tensors (``FakeTensorMode``
  on the device of its arguments): every tensor argument becomes a fake
  tensor of its shape, dtype and device, nothing is allocated or run, and
  each kernel of the port is one ``torch.ops.repro_torch`` node (its fake
  impl, :mod:`repro_torch.kernels.library`).  A data-dependent op or a
  host sync (``.item()``, ``.tolist()``, ``nonzero``) makes the trace
  raise: :class:`TraceError` names the op and its call site.
* :func:`iter_nodes` — every node, nested ``GraphModule``s included, with
  a ``path`` locating it; :func:`node_where` is its user call site.
* :class:`TaintWalker` — forward label propagation with a small constant
  folder.  Seed the placeholders with role labels (``pages``,
  ``block_tables``, ``validity``) and the walker pushes the union of
  input labels onto every node's output.  Two rules carry the serving
  stack's aliasing contract:

  - ``where`` whose predicate is validity-derived and one of whose cases
    is a constant zero gets the extra label ``trash0``: the traced form of
    ``torch.where(valid, page, 0)``, the trash-page guard.  The zero
    reaches ``where.self`` as an ``aten.scalar_tensor(0)`` (or as the
    scalar of ``where.ScalarOther``), possibly through ``_to_copy``,
    ``expand``, ``view`` or ``unsqueeze``: hence the constant folder.
  - every write into a ``pages``-labelled tensor or a view of one
    (``index_put_``, ``index_put``, ``_unsafe_index_put``, ``index_copy_``,
    ``scatter_``, ``copy_``), and every ``repro_torch`` op whose mutated
    argument carries ``pages``, is recorded as a :class:`WriteSite` with
    the labels of its destination, indices and updates.  The KV-aliasing
    pass then asserts each pool write is indexed by ``{block_tables,
    trash0}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import traceback
from typing import Iterator, List, Optional, Set, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["WriteSite", "TaintWalker", "TraceError", "trace_step",
           "iter_nodes", "node_where", "op_name", "leaf_labels"]

# roles whose presence in a where's predicate marks it as the trash guard
VALIDITY_ROLES = frozenset({"validity"})
TRASH_LABEL = "trash0"

aten = torch.ops.aten

# ops through which a known constant keeps its value (zero-ness is all that
# matters, so broadcasts and casts keep it too)
_CONST_TRANSPARENT = frozenset({
    aten._to_copy.default, aten.expand.default, aten.view.default,
    aten._unsafe_view.default, aten.reshape.default, aten.unsqueeze.default,
    aten.squeeze.dim, aten.squeeze.default, aten.clone.default,
    aten.alias.default, aten.lift_fresh_copy.default, aten.permute.default,
    aten.t.default, aten.transpose.int, aten.contiguous.default,
})
# ops that make a constant: (op, index of the fill value among its args)
_CONST_MAKERS = {
    aten.scalar_tensor.default: 0, aten.full.default: 1,
    aten.full_like.default: 1, aten.zeros.default: None,
    aten.zeros_like.default: None, aten.new_zeros.default: None,
}
_WHERE = frozenset({aten.where.self, aten.where.ScalarOther,
                    aten.where.ScalarSelf, aten.where.Scalar})
# write ops: the destination is args[0]; the index arguments by position
_WRITES = {
    aten.index_put_.default: (1,), aten.index_put.default: (1,),
    aten._unsafe_index_put.default: (1,), aten.index_copy_.default: (2,),
    aten.index_copy.default: (2,), aten.scatter_.src: (2,),
    aten.scatter_.value: (2,), aten.scatter_add_.default: (2,),
    aten.scatter_reduce_.two: (2,), aten.copy_.default: (),
}
_UPDATE_ARG = {aten.index_put_.default: 2, aten.index_put.default: 2,
               aten._unsafe_index_put.default: 2, aten.index_copy_.default: 3,
               aten.index_copy.default: 3, aten.scatter_.src: 3,
               aten.scatter_add_.default: 3, aten.scatter_reduce_.two: 3,
               aten.copy_.default: 1}
_MAX_CONST_SIZE = 256   # don't drag big arrays through the const env


class TraceError(RuntimeError):
    """The fake trace of a step failed on a data-dependent op or a host
    sync; ``op`` and ``where`` name it."""

    def __init__(self, op: str, where: str, message: str):
        super().__init__(f"{op} @ {where}: {message}")
        self.op, self.where, self.message = op, where, message


def op_name(target) -> str:
    """``aten.index_put_.default`` -> ``"aten.index_put_"``; a
    ``repro_torch`` op -> ``"repro_torch.mmt4d"``."""
    if isinstance(target, torch._ops.OpOverload):
        return f"{target.namespace}.{target._schema.name.split('::')[-1]}"
    return getattr(target, "__name__", str(target))


def _fake_like(mode, t: torch.Tensor, device):
    """A fake tensor of ``t``'s shape, strides and dtype on ``device`` (a
    real tensor keeps its own device; a meta tensor takes ``device``)."""
    if isinstance(t, FakeTensor):
        return t
    if t.device.type == "meta" or device is not None:
        with mode:
            return torch.empty_strided(tuple(t.shape), t.stride(), dtype=t.dtype,
                                       device=device or t.device)
    return mode.from_tensor(t)


_USER_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


_TORCH_DIR = os.path.dirname(torch.__file__)


def _call_site(sites) -> str:
    """The innermost ``(file, line)`` of the port's model code (outside
    the kernel wrappers and the analysis), else of any code outside
    PyTorch and the analysis (a caller's step function)."""
    ours = [s for s in sites if "repro_torch" in s[0]
            and "/kernels/" not in s[0] and "/analysis/" not in s[0]]
    user = [s for s in sites if not s[0].startswith(_TORCH_DIR)
            and "repro_torch/analysis/" not in s[0]]
    pick = (ours or user or [("<unknown call site>", 0)])[-1]
    return f"{pick[0]}:{pick[1]}"


@contextlib.contextmanager
def _port_stack_traces():
    """Have ``make_fx`` keep each node's frames in the port (its own
    filter keeps only ``forward`` methods, which the port's functional
    models have none of)."""
    from torch.fx.experimental.proxy_tensor import PythonKeyTracer
    old = PythonKeyTracer.__dict__.get("_filter_traceback_frames")

    def keep(self, summary):
        return traceback.StackSummary.from_list(
            [f for f in summary if "repro_torch" in f.filename])

    PythonKeyTracer._filter_traceback_frames = keep
    try:
        yield
    finally:
        if old is None:
            del PythonKeyTracer._filter_traceback_frames
        else:
            PythonKeyTracer._filter_traceback_frames = old


def trace_step(fn, args: tuple, *, device=None,
               stacks: bool = True) -> torch.fx.GraphModule:
    """``make_fx(fn, tracing_mode="fake")(*args)`` under a fresh
    ``FakeTensorMode``: each tensor leaf of ``args`` becomes a fake tensor
    of its shape, dtype and device (a meta leaf, or every leaf with
    ``device``, on ``device``); leaves already fake stay as they are, and
    their mode is the trace's.  Non-tensor leaves stay what they are.
    The graph's placeholders follow ``args``' pytree leaves in order
    (:func:`leaf_labels`).  A data-dependent op or a host sync in ``fn``
    raises :class:`TraceError`.  ``stacks``: record each node's call site
    (:func:`node_where`; about a third of the trace's time)."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException,
                                               FakeTensorMode)
    from torch.fx.experimental.proxy_tensor import make_fx

    # tensors already fake (an engine built under a FakeTensorMode) keep
    # their mode: one trace cannot mix two
    mode = next((t.fake_mode for t in pytree.tree_leaves(tuple(args))
                 if isinstance(t, FakeTensor)), None) \
        or FakeTensorMode(allow_non_fake_inputs=True)
    fake = pytree.tree_map(
        lambda t: _fake_like(mode, t, device) if isinstance(t, torch.Tensor) else t,
        tuple(args))
    try:
        with _port_stack_traces():
            # through *args: make_fx counts a method's defaulted parameters
            return make_fx(lambda *a: fn(*a), tracing_mode="fake",
                           record_stack_traces=stacks)(*fake)
    except (DataDependentOutputException, DynamicOutputShapeException) as e:
        func = getattr(e, "func", None)
        name = op_name(func) if func is not None else type(e).__name__
        site = _call_site([(f.filename, f.lineno)
                           for f in traceback.extract_tb(e.__traceback__)])
        raise TraceError(name, site, f"{type(e).__name__}: the step's output "
                         f"or a shape depends on tensor data (a host sync "
                         f"or a data-dependent op)") from e


def leaf_labels(args: tuple, role_of_arg: dict) -> List[Set[str]]:
    """One label set per pytree leaf of ``args`` (the placeholders of
    :func:`trace_step`'s graph, in order).  ``role_of_arg``: argument
    position -> role, or a callable of the leaf's path string -> role or
    None (a cache tree whose ``*_pages`` leaves are the pool)."""
    out = []
    for path, _leaf in pytree.tree_flatten_with_path(tuple(args))[0]:
        role = role_of_arg.get(path[0].idx)
        if callable(role):
            role = role(pytree.keystr(path[1:]))
        out.append({role} if role else set())
    return out


def _subgraphs(gm: torch.fx.GraphModule, node) -> list:
    """The ``GraphModule``s a node calls (a higher-order op's get_attr
    operands, or a ``call_module`` target)."""
    subs = []
    if node.op == "call_module":
        mod = gm.get_submodule(node.target)
        if isinstance(mod, torch.fx.GraphModule):
            subs.append((node.target, mod))
    for a in pytree.tree_leaves((node.args, node.kwargs)):
        if isinstance(a, torch.fx.Node) and a.op == "get_attr":
            mod = getattr(gm, a.target, None)
            if isinstance(mod, torch.fx.GraphModule):
                subs.append((a.target, mod))
    return subs


def iter_nodes(gm: torch.fx.GraphModule,
               path: str = "top") -> Iterator[Tuple[str, object]]:
    """Yield ``(path, node)`` for every node, recursing into the
    ``GraphModule``s a node calls."""
    for node in gm.graph.nodes:
        yield path, node
        for name, sub in _subgraphs(gm, node):
            yield from iter_nodes(sub, f"{path}/{name}")


def node_where(node) -> str:
    """The user call site of a node, as ``file:line``: the innermost frame
    of the port's model code in its recorded stack trace, or
    ``<unknown call site>``."""
    frames = _USER_FRAME.findall(node.meta.get("stack_trace") or "")
    return _call_site([(f, int(line)) for f, line, _ in frames])


@dataclasses.dataclass
class WriteSite:
    """One in-place write seen by the taint walker, with the provenance
    labels of each operand group (the reference's ``mode``, a scatter's
    out-of-bounds policy, has no aten counterpart)."""

    prim: str
    path: str
    where: str
    operand_labels: Set[str]
    index_labels: Set[str]
    update_labels: Set[str]

    def writes(self, label: str) -> bool:
        return label in self.operand_labels


def _all_zero(a) -> bool:
    return a is not None and bool((np.asarray(a) == 0).all())


def _mutated_args(target) -> List[int]:
    """Positions of the arguments a ``repro_torch`` op writes in place."""
    return [i for i, a in enumerate(target._schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write]


class TaintWalker:
    """Forward label propagation over a traced graph (module docstring)."""

    def __init__(self, validity_roles=VALIDITY_ROLES):
        self.validity_roles = frozenset(validity_roles)
        self.write_sites: List[WriteSite] = []
        self.out_labels: List[Set[str]] = []

    def run(self, gm: torch.fx.GraphModule, arg_labels: List[Optional[Set[str]]]):
        """``arg_labels`` aligns with the graph's placeholders."""
        phs = [n for n in gm.graph.nodes if n.op == "placeholder"]
        if len(arg_labels) != len(phs):
            raise ValueError(f"taint walk: {len(arg_labels)} labels for "
                             f"{len(phs)} placeholders")
        env = {n: set(lab or ()) for n, lab in zip(phs, arg_labels)}
        out = self._walk(gm, env, {}, "top")
        self.out_labels = out
        return self

    @staticmethod
    def _labels(a, env) -> Set[str]:
        got: Set[str] = set()
        for x in pytree.tree_leaves(a):
            if isinstance(x, torch.fx.Node):
                got |= env.get(x, set())
        return got

    @staticmethod
    def _const(a, cenv):
        """A known constant value of an argument: a Python number, or a
        node the folder knows."""
        if isinstance(a, torch.fx.Node):
            return cenv.get(a)
        if isinstance(a, (bool, int, float)):
            return np.asarray(a)
        return None

    def _walk(self, gm, env, cenv, path) -> List[Set[str]]:
        outputs: List[Set[str]] = []
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                env.setdefault(node, set())
                continue
            if node.op == "output":
                outputs = [self._labels(a, env) for a in
                           pytree.tree_leaves(node.args[0])]
                continue
            if node.op == "get_attr":
                env[node] = set()
                val = getattr(gm, node.target, None)
                if (isinstance(val, torch.Tensor) and val.numel() <= _MAX_CONST_SIZE
                        and not isinstance(val, FakeTensor)):
                    cenv[node] = val.detach().cpu().numpy()
                continue
            union = self._labels((node.args, node.kwargs), env)
            target = node.target
            if _subgraphs(gm, node):
                # a higher-order op: conservatively, every output carries
                # every input's labels (a pool write hidden here surfaces
                # as a missing write site, which the aliasing pass reports)
                env[node] = union
                continue
            out = set(union)
            args = node.args
            if target in _CONST_TRANSPARENT and args:
                c = self._const(args[0], cenv)
                if c is not None:
                    cenv[node] = c
            elif target in _CONST_MAKERS:
                i = _CONST_MAKERS[target]
                c = np.asarray(0) if i is None else self._const(
                    args[i] if len(args) > i else node.kwargs.get("fill_value"),
                    cenv)
                if c is not None and np.size(c) <= _MAX_CONST_SIZE:
                    cenv[node] = c
            elif target in _WHERE and len(args) >= 3:
                pred = self._labels(args[0], env)
                if (pred & self.validity_roles
                        and any(_all_zero(self._const(a, cenv)) for a in args[1:3])):
                    out.add(TRASH_LABEL)
            elif target in _WRITES:
                self._record_write(node, env, path)
            elif (isinstance(target, torch._ops.OpOverload)
                  and target.namespace == "repro_torch"):
                for i in _mutated_args(target):
                    if i < len(args) and "pages" in self._labels(args[i], env):
                        others = [a for j, a in enumerate(args) if j != i]
                        self.write_sites.append(WriteSite(
                            prim=op_name(target), path=path, where=node_where(node),
                            operand_labels=self._labels(args[i], env),
                            index_labels=self._labels(others, env),
                            update_labels=self._labels(others, env)))
            env[node] = out
        return outputs

    def _record_write(self, node, env, path) -> None:
        target, args = node.target, node.args
        dest = self._labels(args[0], env)
        if "pages" not in dest:
            return
        if _WRITES[target]:
            idx = self._labels([args[i] for i in _WRITES[target]
                                if i < len(args)], env)
        else:
            # copy_ into a view of the pool: the view's own labels, beyond
            # the pool's, are what addressed it
            idx = dest - {"pages"}
        u = _UPDATE_ARG.get(target)
        upd = self._labels(args[u], env) if u is not None and u < len(args) else set()
        self.write_sites.append(WriteSite(
            prim=op_name(target), path=path, where=node_where(node),
            operand_labels=dest, index_labels=idx, update_labels=upd))
