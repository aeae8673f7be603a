"""AST invariant lint (stdlib ``ast``: nothing runs, nothing is imported).

Rules of the port that no runtime test can see, checked syntactically
over ``src/repro_torch/serving``, ``kernels`` and ``obs``:

* **allocator-privacy**: the free list and the refcount dict
  (``._free``/``._ref``) are mutated only inside ``kv_cache.py``.  A
  ``pool._free.append(p)`` anywhere else bypasses the double-free check
  and the refcount ledger; reads are allowed, writes are not.
* **capacity-asserts**: admission and growth guards (``assert`` and
  ``if ...: raise``) in ``serving/`` reason in ``usable_pages`` /
  ``num_available`` (free plus reclaimable prefix-cache pages), never the
  raw ``free_pages``/``num_free``, which shrink exactly when the prefix
  cache holds spare pages.
* **unseeded-randomness**: no draw from a hidden global generator: stdlib
  ``random.*``, numpy's legacy ``np.random.*``, ``default_rng()`` /
  ``RandomState()`` without a seed, ``torch.rand``/``randn``/``randint``/
  ``randperm``/``normal``/``multinomial``/``bernoulli`` without
  ``generator=``, and ``torch.manual_seed`` (or ``torch.seed``,
  ``torch.cuda.manual_seed``), which reseeds the global generator.
  Serving is deterministic by construction: the token-identity contracts
  and the (seed, rid, position) sampling rule depend on it.
* **monotonic-clock**: wall-time measurement in ``serving/`` and
  ``obs/`` uses ``time.perf_counter()``, never ``time.time()``, which NTP
  can step backwards.
* **kernel-oracle**: every kernel package (``kernels/<name>/ops.py`` that
  launches the library built from ``csrc/*.cu``) keeps a ``ref.py``, the
  plain version, and some ``tests/test_torch_*.py`` imports it (the
  module, or a name it defines).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis.report import Finding

__all__ = ["lint_paths", "lint_file", "lint_kernel_oracles"]

_PASS = "ast-lint"

_PRIVATE_ATTRS = frozenset({"_free", "_ref"})
_MUTATORS = frozenset({"append", "extend", "insert", "pop", "remove",
                       "clear", "update", "setdefault", "popitem",
                       "__setitem__", "sort", "reverse"})
_RAW_CAPACITY = frozenset({"free_pages", "num_free"})

_NP_UNSEEDED = frozenset({
    "random", "rand", "randn", "randint", "random_integers", "choice",
    "shuffle", "permutation", "uniform", "normal", "standard_normal",
    "beta", "binomial", "poisson", "exponential", "gamma", "sample",
    "ranf", "random_sample", "bytes", "seed",
})
_STDLIB_UNSEEDED = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "sample", "uniform", "gauss", "normalvariate", "getrandbits",
    "seed", "betavariate", "expovariate",
})
# torch draws that take a generator= (unseeded without one)
_TORCH_DRAWS = frozenset({"rand", "randn", "randint", "randperm", "normal",
                          "multinomial", "bernoulli"})
# torch calls that reseed a global generator
_TORCH_RESEED = frozenset({"manual_seed", "manual_seed_all", "seed"})


def _dotted(node) -> Optional[List[str]]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: Path, *, allocator_owner: bool,
                 serving_file: bool, clock_file: bool):
        self.path = path
        self.allocator_owner = allocator_owner
        self.serving_file = serving_file
        self.clock_file = clock_file
        self.findings: List[Finding] = []
        self._numpy_aliases = {"numpy"}
        self._torch_aliases = {"torch"}
        self._stdlib_random_aliases = set()
        self._time_aliases = set()
        self._walltime_names = set()     # names bound to time.time itself

    def _add(self, rule: str, node, message: str) -> None:
        self.findings.append(Finding(
            _PASS, rule, f"{self.path}:{getattr(node, 'lineno', '?')}",
            message))

    # ---- imports -------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            name = a.asname or a.name.split(".")[0]
            top = a.name.split(".")[0]
            if a.name == "random":
                self._stdlib_random_aliases.add(name)
            elif top == "numpy":
                self._numpy_aliases.add(name)
            elif top == "torch":
                self._torch_aliases.add(name)
            elif a.name == "time":
                self._time_aliases.add(name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "random":
            for a in node.names:
                if a.name in _STDLIB_UNSEEDED:
                    self._add("unseeded-randomness", node,
                              f"'from random import {a.name}' pulls a "
                              f"global-state draw into deterministic code: "
                              f"use a seeded np.random.Generator or "
                              f"torch.Generator")
        if node.module == "torch":
            for a in node.names:
                if a.name in _TORCH_DRAWS | _TORCH_RESEED:
                    self._add("unseeded-randomness", node,
                              f"'from torch import {a.name}' hides a "
                              f"global-generator call: call torch.{a.name} "
                              f"with generator=")
        if node.module == "time":
            for a in node.names:
                if a.name == "time":
                    self._walltime_names.add(a.asname or a.name)
        self.generic_visit(node)

    # ---- allocator privacy --------------------------------------------
    def _private_attr(self, node) -> Optional[str]:
        if isinstance(node, ast.Attribute) and node.attr in _PRIVATE_ATTRS:
            return node.attr
        if isinstance(node, ast.Subscript):
            return self._private_attr(node.value)
        return None

    def _flag_mutation(self, node, attr: str) -> None:
        if not self.allocator_owner:
            self._add("allocator-privacy", node,
                      f"mutation of allocator-private '.{attr}' outside "
                      f"kv_cache.py: free-list/refcount writes bypass the "
                      f"double-free check and the ledger; go through "
                      f"PagedKVPool.alloc/share/free/cow")

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            attr = self._private_attr(t)
            if attr:
                self._flag_mutation(node, attr)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        attr = self._private_attr(node.target)
        if attr:
            self._flag_mutation(node, attr)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            attr = self._private_attr(t)
            if attr:
                self._flag_mutation(node, attr)
        self.generic_visit(node)

    # ---- calls ---------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
            attr = self._private_attr(fn.value)
            if attr:
                self._flag_mutation(node, attr)
        parts = _dotted(fn)
        if parts:
            self._check_random_call(node, parts)
            if self.clock_file:
                self._check_clock_call(node, parts)
        self.generic_visit(node)

    def _check_clock_call(self, node, parts: List[str]) -> None:
        wall = ((len(parts) == 2 and parts[0] in self._time_aliases
                 and parts[1] == "time")
                or (len(parts) == 1 and parts[0] in self._walltime_names))
        if wall:
            self._add("monotonic-clock", node,
                      f"'{'.'.join(parts)}(...)' reads the adjustable wall "
                      f"clock: serving/obs measurement must use "
                      f"time.perf_counter(), which is monotonic (NTP can "
                      f"step time.time() backwards into negative spans)")

    def _check_random_call(self, node, parts: List[str]) -> None:
        head, tail = parts[0], parts[-1]
        if (head in self._stdlib_random_aliases and len(parts) == 2
                and tail in _STDLIB_UNSEEDED):
            self._add("unseeded-randomness", node,
                      f"stdlib '{'.'.join(parts)}(...)' draws from the "
                      f"hidden global generator: use a seeded one")
            return
        if head in self._torch_aliases:
            module = parts[1:-1]
            if module in ([], ["cuda"]) and tail in _TORCH_RESEED:
                self._add("unseeded-randomness", node,
                          f"'{'.'.join(parts)}(...)' reseeds a global "
                          f"generator that other code draws from: seed a "
                          f"torch.Generator and pass it as generator=")
            elif (not module and tail in _TORCH_DRAWS
                  and not any(k.arg == "generator" for k in node.keywords)):
                self._add("unseeded-randomness", node,
                          f"'{'.'.join(parts)}(...)' without generator= "
                          f"draws from the global generator: pass a seeded "
                          f"torch.Generator")
            return
        if not (len(parts) >= 3 and head in self._numpy_aliases
                and parts[1] == "random"):
            return
        if tail in _NP_UNSEEDED:
            self._add("unseeded-randomness", node,
                      f"'{'.'.join(parts)}(...)' uses numpy's legacy global "
                      f"generator: construct a seeded np.random.Generator")
        elif tail in ("default_rng", "RandomState") and not (node.args or
                                                             node.keywords):
            self._add("unseeded-randomness", node,
                      f"'{'.'.join(parts)}()' without a seed is "
                      f"entropy-seeded: pass an explicit seed")

    # ---- capacity guards -----------------------------------------------
    def _check_capacity(self, test, node, what: str) -> None:
        for sub in ast.walk(test):
            if isinstance(sub, ast.Attribute) and sub.attr in _RAW_CAPACITY:
                self._add("capacity-asserts", node,
                          f"{what} reasons about raw '.{sub.attr}': use "
                          f"usable_pages/num_available; the free list "
                          f"shrinks while the prefix cache holds "
                          f"reclaimable pages, so this {what} fires exactly "
                          f"when the cache works")

    def visit_Assert(self, node: ast.Assert) -> None:
        if self.serving_file:
            self._check_capacity(node.test, node, "assert")
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        # a failure path written as `if <cond>: raise ...` is held to the
        # same rule as the assert it stands for
        if self.serving_file and any(isinstance(b, ast.Raise)
                                     for b in node.body):
            self._check_capacity(node.test, node, "raise-guard")
        self.generic_visit(node)


def lint_file(path: Path, *, serving_root: Optional[Path] = None,
              clock_roots: tuple = ()) -> List[Finding]:
    """Lint one file.  ``serving_root`` scopes the capacity rule,
    ``clock_roots`` (directories) the monotonic-clock rule."""
    path = Path(path)
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        return [Finding(_PASS, "syntax", f"{path}:{e.lineno}",
                        f"unparseable: {e.msg}")]
    parents = path.resolve().parents
    serving_file = (serving_root is not None
                    and Path(serving_root).resolve() in parents)
    clock_file = any(Path(r).resolve() in parents for r in clock_roots)
    linter = _FileLinter(path, allocator_owner=path.name == "kv_cache.py",
                         serving_file=serving_file, clock_file=clock_file)
    linter.visit(tree)
    return linter.findings


def lint_paths(paths, *, serving_root: Optional[Path] = None,
               clock_roots: tuple = ()) -> List[Finding]:
    findings: List[Finding] = []
    for root in paths:
        root = Path(root)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for p in files:
            findings.extend(lint_file(p, serving_root=serving_root,
                                      clock_roots=clock_roots))
    return findings


def _top_level_names(tree: ast.Module) -> set:
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return names


def _launches(ops: Path) -> bool:
    """Does ``ops.py`` load the library built from ``csrc/*.cu``?"""
    tree = ast.parse(ops.read_text(), filename=str(ops))
    return any(isinstance(n, ast.Call) and (_dotted(n.func) or [""])[-1]
               == "load_library" for n in ast.walk(tree))


def lint_kernel_oracles(kernels_dir, tests_dir) -> List[Finding]:
    """Every kernel package (an ``ops.py`` that launches a ``csrc``
    kernel) keeps a ``ref.py`` that some ``test_torch_*.py`` imports, the
    module itself or a name defined in it."""
    findings: List[Finding] = []
    kernels_dir, tests_dir = Path(kernels_dir), Path(tests_dir)
    test_imports = []          # (module, names) per import
    for tf in sorted(tests_dir.glob("test_torch_*.py")):
        try:
            tree = ast.parse(tf.read_text(), filename=str(tf))
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                test_imports.append((node.module,
                                     {a.name for a in node.names}))
            elif isinstance(node, ast.Import):
                test_imports.extend((a.name, set()) for a in node.names)

    for pkg in sorted(p for p in kernels_dir.iterdir()
                      if p.is_dir() and (p / "ops.py").exists()
                      and _launches(p / "ops.py")):
        ref = pkg / "ref.py"
        if not ref.exists():
            findings.append(Finding(
                _PASS, "kernel-oracle", str(pkg),
                f"kernel package '{pkg.name}' has no ref.py: every CUDA "
                f"kernel keeps its plain PyTorch version as its spec"))
            continue
        ref_names = _top_level_names(ast.parse(ref.read_text()))
        ref_mod = f"repro_torch.kernels.{pkg.name}.ref"
        pkg_mod = f"repro_torch.kernels.{pkg.name}"
        imported = any(
            mod == ref_mod or mod.startswith(ref_mod + ".")
            or (mod == pkg_mod and "ref" in names)
            or (mod == pkg_mod and names & ref_names)
            for mod, names in test_imports)
        if not imported:
            findings.append(Finding(
                _PASS, "kernel-oracle", str(pkg),
                f"no test_torch_*.py imports {ref_mod} (or a name it "
                f"defines): the plain version is the kernel's spec and "
                f"must stay under test"))
    return findings
