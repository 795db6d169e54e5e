"""Layer-1 AST passes (stdlib ``ast`` only — no torch or jax import).

The JAX package's six rules (``repro/analysis/ast_passes.py``), each also
taught the torch spelling where torch has one; on JAX code they find
exactly what the reference finds.  By default they scan the port's tree
(``registry.DEFAULT_SCAN``):

=========  ==================================================================
ACC-001    kernel files: ``sum``/``dot``/``@`` (and ``torch.sum``/``matmul``/
           ``mm``/``bmm``/``einsum``) on ref-derived data with no f32 upcast
           (``.astype(jnp.float32)`` / ``preferred_element_type`` /
           ``dtype=torch.float32`` / ``.float()`` / ``.to(torch.float32)``)
           in the expression's dataflow
JIT-001    ``jax.jit`` or ``torch.compile`` constructed inside a loop, or
           compile-then-call in one expression (``jax.jit(f)(x)``,
           ``torch.compile(f)(x)``) — a fresh cache per call
OBS-001    f-string / ``str(x)`` label values flowing into metric
           ``.labels()``/``.inc``/``.set``/``.observe`` — unbounded series
           cardinality
DET-001    wall-clock / RNG calls in kernel files, or inside jit/shard_map/
           pallas-traced or ``torch.compile``/``torch.jit.script`` bodies
           (where they freeze into constants); ``torch.*`` draws with an
           explicit ``generator=`` are allowed, as ``jax.random`` is
EXC-001    bare ``except:``
DON-001    use of a buffer after it was passed at a donated position of a
           ``jax.jit(..., donate_argnums=...)`` callable
=========  ==================================================================

Layer 1 is deliberately conservative: it flags what it can *prove* from
the source expression, and the layer-2 auditor (``acc_audit``) carries
the real accumulation guarantee — the dtypes of every contraction the
plain versions dispatch, and the kernels' results against an f64 oracle.
"""

from __future__ import annotations

import ast

from .findings import Finding
from .registry import Context, register_pass

__all__ = []

_F32_NAMES = ("float32", "f32")
_REDUCER_FUNCS = {"jnp.sum", "jnp.dot", "jnp.matmul", "jnp.einsum",
                  "jax.numpy.sum", "jax.numpy.dot", "jax.numpy.matmul",
                  "jax.numpy.einsum", "lax.dot_general",
                  "jax.lax.dot_general", "pl.dot", "torch.sum",
                  "torch.matmul", "torch.mm", "torch.bmm", "torch.einsum"}
# constructors of a traced, compile-cached callable
_JIT_CTORS = ("jax.jit", "jit", "torch.compile")
# ... and everything whose body is traced once and frozen
_TRACERS = _JIT_CTORS + ("torch.jit.script",)
# torch draws from the global generator unless given ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "rand_like",
                "randn_like", "randint_like", "normal", "bernoulli",
                "multinomial", "poisson"}
_CLOCK_CALLS = {"time.time", "time.monotonic", "time.perf_counter",
                "time.process_time", "time.time_ns", "time.monotonic_ns",
                "time.perf_counter_ns", "datetime.now", "datetime.utcnow",
                "datetime.datetime.now", "datetime.datetime.utcnow"}
_RNG_PREFIXES = ("random.", "np.random.", "numpy.random.")
_METRIC_METHODS = {"labels", "inc", "set", "observe"}


def _dotted(node) -> str | None:
    """Dotted name of a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_kernel_file(rel_path: str) -> bool:
    return "kernels" in rel_path.replace("\\", "/").split("/")


def _mentions_f32(node) -> bool:
    d = _dotted(node)
    if d and d.rsplit(".", 1)[-1] in _F32_NAMES:
        return True
    return isinstance(node, ast.Constant) and node.value in ("float32", "f32")


def _has_f32_evidence(node) -> bool:
    """True if the expression subtree upcasts to f32 anywhere: an
    ``.astype(float32)`` / ``.to(torch.float32)`` / ``.float()`` call, a
    ``preferred_element_type=f32`` kwarg, or an f32 ``dtype=`` kwarg."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr in ("astype", "to") \
                    and any(_mentions_f32(a) for a in sub.args):
                return True
            if isinstance(sub.func, ast.Attribute) \
                    and sub.func.attr == "float" and not sub.args:
                return True
            for kw in sub.keywords:
                if kw.arg in ("preferred_element_type", "dtype") \
                        and _mentions_f32(kw.value):
                    return True
    return False


def _names_in(node) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


# --------------------------------------------------------------- ACC-001

class _AccVisitor(ast.NodeVisitor):
    """Per-function dataflow over ref-derived values in a kernel file.

    Params ending in ``_ref`` (and a ``*refs`` vararg) seed the tainted
    set; assignments propagate it, except that an RHS carrying f32
    evidence moves the target to the clean set.  Reductions touching a
    tainted name without local f32 evidence are flagged.
    """

    def __init__(self, rel_path: str, findings: list[Finding]):
        self.rel = rel_path
        self.findings = findings

    def visit_FunctionDef(self, node):
        self._check_function(node)
        # nested defs handled inside _check_function

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check_function(self, fn):
        args = fn.args
        names = [a.arg for a in args.args + args.posonlyargs
                 + args.kwonlyargs]
        if args.vararg:
            names.append(args.vararg.arg)
        tainted = {n for n in names if n.endswith("_ref") or n == "refs"}
        clean: set[str] = set()

        def is_tainted(expr) -> bool:
            for n in _names_in(expr):
                if n in clean:
                    continue
                if n in tainted or n.endswith("_ref"):
                    return True
            return False

        def scan(stmts):
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._check_function(st)
                    continue
                for node in ast.walk(st):
                    red = self._reduction(node)
                    if red and is_tainted(node) \
                            and not _has_f32_evidence(node):
                        self.findings.append(Finding(
                            rule="ACC-001", path=self.rel,
                            line=node.lineno,
                            message=f"{red} over ref-derived data with no "
                                    "f32 upcast in the expression "
                                    "(low-precision accumulation)"))
                if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                        and isinstance(st.targets[0], ast.Name):
                    tgt = st.targets[0].id
                    if is_tainted(st.value):
                        if _has_f32_evidence(st.value):
                            clean.add(tgt)
                            tainted.discard(tgt)
                        else:
                            tainted.add(tgt)
                            clean.discard(tgt)
                # recurse into compound statements' bodies
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(st, field, None)
                    if sub and not isinstance(
                            st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        scan(sub)

        scan(fn.body)

    @staticmethod
    def _reduction(node) -> str | None:
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            return "matmul (@)"
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "sum":
                return ".sum()"
            d = _dotted(node.func)
            if d in _REDUCER_FUNCS:
                return d
        return None


@register_pass("ACC-001", "kernel-accumulation", 1,
               "low-precision accumulation on refs in kernel files")
def acc_pass(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for rel, tree in ctx.iter_trees():
        if not _is_kernel_file(rel):
            continue
        _AccVisitor(rel, findings).visit(tree)
    return findings


# --------------------------------------------------------------- JIT-001

def _is_jit_ctor(node) -> bool:
    if not isinstance(node, ast.Call):
        return False
    d = _dotted(node.func)
    if d in _JIT_CTORS:
        return True
    # functools.partial(jax.jit, ...) builds the same fresh-cache wrapper
    if d == "functools.partial" and node.args \
            and _dotted(node.args[0]) in _JIT_CTORS:
        return True
    return False


@register_pass("JIT-001", "per-call-jit", 1,
               "jax.jit / torch.compile constructed inside a loop or "
               "compile-then-call in one expression (re-jit hazard)")
def jit_pass(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    seen: set[tuple[str, int, str]] = set()

    def emit(rel, line, kind, message):
        if (rel, line, kind) not in seen:     # nested loops: flag once
            seen.add((rel, line, kind))
            findings.append(Finding(rule="JIT-001", path=rel, line=line,
                                    message=message))

    for rel, tree in ctx.iter_trees():
        for node in ast.walk(tree):
            if isinstance(node, (ast.For, ast.While)):
                for sub in ast.walk(node):
                    if sub is node:
                        continue
                    if _is_jit_ctor(sub):
                        emit(rel, sub.lineno, "loop",
                             "jax.jit / torch.compile constructed inside "
                             "a loop — each "
                             "iteration builds a fresh wrapper with an "
                             "empty compile cache")
            if isinstance(node, ast.Call) and _is_jit_ctor(node.func):
                emit(rel, node.lineno, "call",
                     "compile-then-call in one expression (jax.jit(f)(x), "
                     "torch.compile(f)(x)) — "
                     "the wrapper and its cache are discarded after the "
                     "call")
    return findings


# --------------------------------------------------------------- OBS-001

def _unbounded_label(value) -> str | None:
    if isinstance(value, ast.JoinedStr) \
            and any(isinstance(v, ast.FormattedValue) for v in value.values):
        return "f-string"
    if isinstance(value, ast.Call):
        d = _dotted(value.func)
        if d in ("str", "repr"):
            return f"{d}()"
        if isinstance(value.func, ast.Attribute) \
                and value.func.attr == "format":
            return ".format()"
    return None


@register_pass("OBS-001", "label-cardinality", 1,
               "f-string/str(x) values flowing into metric labels")
def obs_pass(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for rel, tree in ctx.iter_trees():
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _METRIC_METHODS):
                continue
            for kw in node.keywords:
                if kw.arg is None:
                    continue
                why = _unbounded_label(kw.value)
                if why:
                    findings.append(Finding(
                        rule="OBS-001", path=rel, line=node.lineno,
                        message=f"label {kw.arg!r} built from {why} — "
                                "unbounded series cardinality (one "
                                "timeseries per distinct value)"))
    return findings


# --------------------------------------------------------------- DET-001

def _forbidden_call(node) -> str | None:
    if not isinstance(node, ast.Call):
        return None
    d = _dotted(node.func)
    if d is None:
        return None
    if d in _CLOCK_CALLS:
        return d
    if any(d.startswith(p) for p in _RNG_PREFIXES):
        return d         # jax.random is fine: explicit keys, deterministic
    parts = d.split(".")
    if len(parts) == 2 and parts[0] == "torch" and parts[1] in _TORCH_DRAWS \
            and not any(kw.arg == "generator" for kw in node.keywords):
        return d         # a torch draw with generator= is as explicit
    return None


def _traced_function_names(tree) -> set[str]:
    """Names of functions this module traces: passed to jax.jit /
    shard_map / pallas_call / torch.compile / torch.jit.script, or
    decorated with one of those forms."""
    traced: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            d = _dotted(node.func)
            if d and (d in _TRACERS
                      or d.endswith("shard_map")
                      or d.endswith("pallas_call")):
                for a in node.args[:1]:
                    if isinstance(a, ast.Name):
                        traced.add(a.id)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _dotted(dec) in _TRACERS or _is_jit_ctor(dec):
                    traced.add(node.name)
    return traced


@register_pass("DET-001", "determinism", 1,
               "wall-clock / RNG reads in kernels or traced bodies")
def det_pass(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for rel, tree in ctx.iter_trees():
        if _is_kernel_file(rel):
            for node in ast.walk(tree):
                d = _forbidden_call(node)
                if d:
                    findings.append(Finding(
                        rule="DET-001", path=rel, line=node.lineno,
                        message=f"{d}() in a kernel file — kernels must "
                                "be deterministic pure functions of "
                                "their operands"))
            continue
        traced = _traced_function_names(tree)
        if not traced:
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in traced:
                for sub in ast.walk(node):
                    d = _forbidden_call(sub)
                    if d:
                        findings.append(Finding(
                            rule="DET-001", path=rel, line=sub.lineno,
                            message=f"{d}() inside traced "
                                    f"{node.name}() — evaluates once at "
                                    "trace time and freezes into the "
                                    "compiled program"))
    return findings


# --------------------------------------------------------------- EXC-001

@register_pass("EXC-001", "bare-except", 1, "bare except clauses")
def exc_pass(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for rel, tree in ctx.iter_trees():
        for node in ast.walk(tree):
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                findings.append(Finding(
                    rule="EXC-001", path=rel, line=node.lineno,
                    message="bare except swallows KeyboardInterrupt/"
                            "SystemExit — name the exceptions"))
    return findings


# --------------------------------------------------------------- DON-001

def _donated_positions(call: ast.Call) -> tuple[int, ...] | None:
    for kw in call.keywords:
        if kw.arg == "donate_argnums":
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return (v.value,)
            if isinstance(v, (ast.Tuple, ast.List)):
                out = tuple(e.value for e in v.elts
                            if isinstance(e, ast.Constant)
                            and isinstance(e.value, int))
                return out or None
    return None


class _DonationScope:
    """One lexical scope's donating callables and use-after-donate scan."""

    def __init__(self, rel, findings, donors):
        self.rel = rel
        self.findings = findings
        self.donors = dict(donors)   # name -> donated positions

    def scan(self, body):
        # first pass: pick up donor bindings declared in this scope
        for st in body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name) \
                    and isinstance(st.value, ast.Call) \
                    and _is_jit_ctor(st.value):
                pos = _donated_positions(st.value)
                if pos:
                    self.donors[st.targets[0].id] = pos
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in st.decorator_list:
                    if isinstance(dec, ast.Call) and _is_jit_ctor(dec):
                        pos = _donated_positions(dec)
                        if pos:
                            self.donors[st.name] = pos
        if not self.donors:
            return
        # second pass: donation sites and later uses, by line number
        donations: list[tuple[str, int]] = []   # (buffer name, call line)
        uses: list[tuple[str, int]] = []
        rebinds: list[tuple[str, int]] = []
        call_arg_lines: set[tuple[str, int]] = set()
        for st in body:
            for node in ast.walk(st):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name) \
                        and node.func.id in self.donors:
                    for p in self.donors[node.func.id]:
                        if p < len(node.args) \
                                and isinstance(node.args[p], ast.Name):
                            name = node.args[p].id
                            donations.append((name, node.lineno))
                            call_arg_lines.add((name, node.lineno))
                if isinstance(node, ast.Name):
                    uses.append((node.id, node.lineno))
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            rebinds.append((t.id, node.lineno))
        for name, dline in donations:
            rebind_after = min((ln for n, ln in rebinds
                                if n == name and ln >= dline),
                               default=None)
            for uname, uline in uses:
                if uname != name or uline <= dline:
                    continue
                if (uname, uline) in call_arg_lines:
                    continue
                if rebind_after is not None and uline >= rebind_after:
                    break
                self.findings.append(Finding(
                    rule="DON-001", path=self.rel, line=uline,
                    message=f"{name!r} used after being donated at line "
                            f"{dline} — a donated buffer's memory is "
                            "reused by the jitted program"))
                break   # one finding per donation site


@register_pass("DON-001", "donated-buffer-reuse", 1,
               "mutation/use of donated buffers after dispatch")
def don_pass(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    for rel, tree in ctx.iter_trees():
        module_scope = _DonationScope(rel, findings, {})
        module_scope.scan(tree.body)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _DonationScope(rel, findings,
                               module_scope.donors).scan(node.body)
    return findings
