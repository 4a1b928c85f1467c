"""flashlint rules for the port: the AST project linter behind
``python -m repro_torch.analysis``, as `repro.analysis.lint` is the JAX
package's.  The rule codes are the JAX package's, each in torch's idiom.

Rule catalogue (see `RULES`):

  FL001  raw ``torch.distributed`` (an import of it, or a ``torch.distributed``
         attribute chain) anywhere except ``core/mesh.py`` and
         ``launch/mesh.py``, which play the part of the JAX package's
         ``runtime/jaxcompat.py``: process groups, subgroups and collectives
         go through `Mesh` and the `launch.mesh` helpers.

  FL002  host syncs inside the decode stack (``core/`` and ``kernels/``):
         ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
         ``torch.cuda.synchronize()``, and ``float()``/``int()``/``bool()``
         applied to a tensor expression (a ``torch.`` call chain, or a
         subscript of decoder state on ``self``).  Static metadata
         (``.shape``/``.ndim``/``.dtype``/``.device``) is exempt.
         Intentional syncs, such as the online decoders' commit points,
         carry a reasoned disable comment instead of being silent.

  FL003  ``sys.path`` manipulation.

  FL004  legacy string-dispatch ``viterbi_decode(method=...)`` anywhere
         except the pinned shim (``core/api.py``) and tests.  New call sites
         construct a typed `DecodeSpec`.

  FL005  malformed ``flashlint: disable`` comment (unknown rule code or
         missing reason): a disable that does not say *why* suppresses
         nothing.

  FL006  kernel loading (``ctypes``, ``torch.utils.cpp_extension``,
         ``torch.ops.load_library``, ``triton``) outside ``kernels/``, the
         counterpart of raw Pallas outside ``kernels/``: the resource check
         (`analysis.kernel_check`) audits the kernels that ``kernels/``
         builds, and a kernel loaded anywhere else escapes it.

  FL007  manual ``-inf`` masking (``torch.where``, ``np.where`` or
         ``masked_fill`` with a neg-inf-like operand: ``NEG_INF``,
         ``-torch.inf``, ``float("-inf")``, a ``-1e8``-or-larger literal)
         outside ``core/constraints.py`` and ``kernels/``.  Every allowed-set
         mask is an additive `ConstraintSpec` penalty, so offline, batched,
         streaming and kernel paths apply the same float adds; a hand-rolled
         ``where(mask, x, -inf)`` elsewhere forks that contract.  A genuine
         seam (sentinel padding, reduction identities) carries a reasoned
         disable.

Suppression grammar, one or more comma-separated entries::

    x = float(delta[q])  # flashlint: disable=FL002(commit-point transfer)
    # flashlint: disable=FL002(applies to the next line)
    y = psi.cpu().numpy()
    # flashlint: disable-file=FL002(whole file is host-side numpy)

The reason inside ``(...)`` is mandatory.  ``disable-file`` may appear on any
standalone comment line and silences the rule for the entire file.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import pathlib
import re
import tokenize
from typing import Iterable, Iterator

__all__ = ["RULES", "Violation", "lint_source", "lint_file", "lint_paths"]

RULES: dict[str, str] = {
    "FL001": "raw torch.distributed outside core/mesh.py and launch/mesh.py",
    "FL002": "host sync in a decode hot path (core/, kernels/)",
    "FL003": "sys.path manipulation",
    "FL004": "string-dispatch viterbi_decode outside the shim and tests",
    "FL005": "malformed flashlint disable comment",
    "FL006": "kernel loading (ctypes, cpp_extension, load_library, triton) "
             "outside kernels/",
    "FL007": "manual -inf masking outside core/constraints.py and kernels/",
}

# FL001: the namespace that must stay inside the mesh layer.
_FL001_MODULE = "torch.distributed"

# FL006: modules and dotted names that load or build a kernel.
_FL006_MODULES = ("ctypes", "triton", "torch.utils.cpp_extension")
_FL006_DOTTED = {"torch.utils.cpp_extension", "torch.ops.load_library"}

# FL002: methods that copy to the host, dotted calls that block on the
# device, and attributes that never refer to device data.
_FL002_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}
_FL002_SYNC_CALLS = {"torch.cuda.synchronize"}
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda"}
_TRACED_ROOTS = {"torch"}

# FL007: names conventionally bound to the tropical -inf sentinel, and the
# magnitude at which a negative literal is clearly one (core.hmm.NEG_INF is
# -1.0e9; real log-probs never reach -1e8).
_FL007_NEG_NAMES = {"NEG_INF", "_SENTINEL", "_NEG", "_NEG_INF"}
_FL007_MAGNITUDE = 1e8
_FL007_WHERE = {"torch.where", "np.where", "numpy.where"}
_FL007_FILL = {"masked_fill", "masked_fill_"}

_DISABLE_ITEM = re.compile(r"(?P<code>[A-Z]{2}\d{3})\((?P<reason>[^()]*)\)")
_DISABLE_LINE = re.compile(
    r"#\s*flashlint:\s*(?P<kind>disable(?:-file)?)\s*=\s*(?P<body>\S.*)")


@dataclasses.dataclass(frozen=True)
class Violation:
    path: str
    line: int
    col: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"


# ---------------------------------------------------------------------------
# Scope decisions (which rules apply to which files)
# ---------------------------------------------------------------------------

def _parts(path: str) -> tuple[str, ...]:
    return pathlib.PurePath(path).parts


def _is_mesh_layer(path: str) -> bool:
    return _parts(path)[-2:] in (("core", "mesh.py"), ("launch", "mesh.py"))


def _is_hot_path(path: str) -> bool:
    """core/ and kernels/: the decode stack (FL002 scope)."""
    parts = _parts(path)[:-1]
    return "core" in parts or "kernels" in parts


def _is_dispatch_shim(path: str) -> bool:
    return _parts(path)[-2:] == ("core", "api.py")


def _is_kernel_layer(path: str) -> bool:
    """kernels/: the only home of kernel loading (FL006 scope)."""
    return "kernels" in _parts(path)[:-1]


def _is_constraints_file(path: str) -> bool:
    """core/constraints.py: the one home of -inf penalty building."""
    return _parts(path)[-2:] == ("core", "constraints.py")


def _is_test_file(path: str) -> bool:
    parts = _parts(path)
    return ("tests" in parts[:-1] or parts[-1].startswith("test_")
            or parts[-1] == "conftest.py")


# ---------------------------------------------------------------------------
# Disable-comment parsing
# ---------------------------------------------------------------------------

def _parse_disables(src: str, path: str):
    """Returns (line -> {codes}, file-wide {codes}, FL005 violations).

    A disable on a code-bearing line covers that line; a disable on a
    standalone comment line covers the next line (for statements too long to
    carry the comment).  Only real COMMENT tokens count: strings and
    docstrings may mention the grammar without tripping FL005.
    """
    per_line: dict[int, set[str]] = {}
    file_wide: set[str] = set()
    bad: list[Violation] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return per_line, file_wide, bad   # ast.parse reports the real error
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        text, lineno = tok.string, tok.start[0]
        m = _DISABLE_LINE.search(text)
        if not m:
            if "flashlint" in text and "disable" in text:
                bad.append(Violation(path, lineno, 1, "FL005",
                                     "unparseable flashlint disable comment"))
            continue
        codes: set[str] = set()
        body = m.group("body")
        for item in _DISABLE_ITEM.finditer(body):
            code, reason = item.group("code"), item.group("reason").strip()
            if code not in RULES:
                bad.append(Violation(path, lineno, 1, "FL005",
                                     f"unknown rule {code!r} in disable"))
            elif not reason:
                bad.append(Violation(
                    path, lineno, 1, "FL005",
                    f"disable of {code} has an empty reason; say why"))
            else:
                codes.add(code)
        leftover = _DISABLE_ITEM.sub("", body).strip().strip(",")
        if leftover and not leftover.startswith("#"):
            bad.append(Violation(
                path, lineno, 1, "FL005",
                f"malformed disable {leftover!r}; use CODE(reason)"))
        standalone = tok.line[:tok.start[1]].strip() == ""
        if m.group("kind") == "disable-file":
            file_wide |= codes
        elif standalone:
            per_line.setdefault(lineno + 1, set()).update(codes)
        else:
            per_line.setdefault(lineno, set()).update(codes)
    return per_line, file_wide, bad


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

def _dotted(node: ast.AST) -> str | None:
    """'a.b.c' for an attribute chain rooted at a Name, else None."""
    names: list[str] = []
    while isinstance(node, ast.Attribute):
        names.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        names.append(node.id)
        return ".".join(reversed(names))
    return None


def _chain_root(node: ast.AST) -> str | None:
    """Root Name of an attribute/subscript/call chain, else None."""
    while True:
        if isinstance(node, ast.Attribute):
            node = node.value
        elif isinstance(node, ast.Subscript):
            node = node.value
        elif isinstance(node, ast.Call):
            node = node.func
        elif isinstance(node, ast.Name):
            return node.id
        else:
            return None


def _mentions_tensor(node: ast.AST) -> bool:
    """Does this expression plausibly touch a tensor?

    True for torch.-rooted call chains and for subscripts of state held on
    ``self`` (the streaming decoders keep their live tensors there).
    Attribute chains through static metadata (.shape/.ndim/.dtype/.device)
    are host Python and never count.
    """
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return False
        root = _chain_root(node)
        return root in _TRACED_ROOTS or _mentions_tensor(node.value)
    if isinstance(node, ast.Subscript):
        return _mentions_tensor(node.value) or _mentions_tensor(node.slice)
    if isinstance(node, ast.Call):
        if any(_mentions_tensor(a) for a in node.args):
            return True
        if any(_mentions_tensor(k.value) for k in node.keywords):
            return True
        return _mentions_tensor(node.func)
    if isinstance(node, ast.Name):
        return node.id == "self"
    if isinstance(node, ast.BinOp):
        return _mentions_tensor(node.left) or _mentions_tensor(node.right)
    if isinstance(node, ast.UnaryOp):
        return _mentions_tensor(node.operand)
    if isinstance(node, (ast.Tuple, ast.List)):
        return any(_mentions_tensor(e) for e in node.elts)
    return False


def _mentions_neg_inf(node: ast.AST) -> bool:
    """Does this expression contain a neg-inf-like constant anywhere?

    Matches the conventional sentinel names (`NEG_INF`, `_SENTINEL`, ...),
    ``.inf`` attributes (``torch.inf`` / ``np.inf`` / ``math.inf``, usually
    under a unary minus), ``float("-inf")``, and negated numeric literals of
    ``-1e8`` magnitude or larger, recursing through arithmetic so scaled
    sentinels like ``4.0 * NEG_INF`` still register.
    """
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in _FL007_NEG_NAMES:
            return True
        if isinstance(sub, ast.Attribute) and sub.attr == "inf":
            return True
        if (isinstance(sub, ast.UnaryOp) and isinstance(sub.op, ast.USub)
                and isinstance(sub.operand, ast.Constant)
                and isinstance(sub.operand.value, (int, float))
                and abs(sub.operand.value) >= _FL007_MAGNITUDE):
            return True
        if (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                and sub.func.id == "float" and len(sub.args) == 1
                and isinstance(sub.args[0], ast.Constant)
                and sub.args[0].value == "-inf"):
            return True
    return False


def _in_namespace(name: str, module: str) -> bool:
    return name == module or name.startswith(module + ".")


# ---------------------------------------------------------------------------
# The visitor
# ---------------------------------------------------------------------------

class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.check_fl001 = not _is_mesh_layer(path)
        self.check_fl002 = _is_hot_path(path)
        self.check_fl004 = not (_is_dispatch_shim(path)
                                or _is_test_file(path))
        self.check_fl006 = not (_is_kernel_layer(path) or _is_test_file(path))
        self.check_fl007 = not (_is_constraints_file(path)
                                or _is_kernel_layer(path)
                                or _is_test_file(path))
        self.found: list[Violation] = []

    def _flag(self, node: ast.AST, code: str, message: str) -> None:
        self.found.append(Violation(self.path, getattr(node, "lineno", 1),
                                    getattr(node, "col_offset", 0) + 1,
                                    code, message))

    def _flag_fl001(self, node: ast.AST, what: str) -> None:
        self._flag(node, "FL001", f"{what}; go through core.mesh.Mesh or the "
                                  f"launch.mesh helpers")

    def _flag_fl006(self, node: ast.AST, what: str) -> None:
        self._flag(node, "FL006", f"{what} outside kernels/; kernels are "
                                  f"built and loaded in repro_torch.kernels, "
                                  f"where the resource check sees them")

    # -- imports (FL001, FL006) ---------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            if self.check_fl001 and _in_namespace(alias.name, _FL001_MODULE):
                self._flag_fl001(node, f"import of {alias.name}")
            if self.check_fl006 and any(_in_namespace(alias.name, m)
                                        for m in _FL006_MODULES):
                self._flag_fl006(node, f"import of {alias.name}")
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        if node.level == 0 and mod:
            names = {a.name for a in node.names}
            if self.check_fl001 and (
                    _in_namespace(mod, _FL001_MODULE)
                    or (mod == "torch" and "distributed" in names)):
                self._flag_fl001(node, f"'from {mod} import ...' of "
                                       f"torch.distributed")
            if self.check_fl006 and (
                    any(_in_namespace(mod, m) for m in _FL006_MODULES)
                    or (mod == "torch.utils" and "cpp_extension" in names)):
                self._flag_fl006(node, f"'from {mod} import ...'")
        self.generic_visit(node)

    # -- attribute references (FL001, FL003, FL006) -------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        dotted = _dotted(node)
        if dotted:
            # exact matches only: for `torch.distributed.all_reduce(...)` the
            # inner `torch.distributed` Attribute node is visited too, so one
            # flag suffices
            if self.check_fl001 and dotted == _FL001_MODULE:
                self._flag_fl001(node, f"raw {dotted}")
            if dotted == "sys.path":
                self._flag(node, "FL003",
                           "sys.path manipulation; use PYTHONPATH=src or an "
                           "editable install")
            if self.check_fl006 and dotted in _FL006_DOTTED:
                self._flag_fl006(node, f"raw {dotted}")
        self.generic_visit(node)

    # -- calls (FL002, FL004, FL007) ----------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if self.check_fl002:
            if (isinstance(func, ast.Attribute)
                    and func.attr in _FL002_SYNC_METHODS
                    and not node.args and not node.keywords):
                self._flag(node, "FL002",
                           f".{func.attr}() copies to the host; keep values "
                           f"on the device or annotate the commit point")
            dotted = _dotted(func) if isinstance(func, ast.Attribute) else None
            if dotted in _FL002_SYNC_CALLS:
                self._flag(node, "FL002",
                           f"{dotted}() blocks on the device in a decode hot "
                           f"path")
            if (isinstance(func, ast.Name)
                    and func.id in ("float", "int", "bool")
                    and len(node.args) == 1
                    and _mentions_tensor(node.args[0])):
                self._flag(node, "FL002",
                           f"{func.id}() of a tensor blocks on the device; "
                           f"batch the transfer or annotate it")
        if self.check_fl004:
            name = (func.id if isinstance(func, ast.Name)
                    else func.attr if isinstance(func, ast.Attribute)
                    else None)
            if name in ("viterbi_decode", "viterbi_decode_hmm"):
                self._flag(node, "FL004",
                           f"legacy {name}(method=...) dispatch; construct "
                           f"a typed DecodeSpec / ViterbiDecoder")
        if self.check_fl007 and isinstance(func, ast.Attribute):
            dotted = _dotted(func)
            masks = (dotted in _FL007_WHERE or func.attr in _FL007_FILL)
            operands = list(node.args) + [k.value for k in node.keywords]
            if masks and any(_mentions_neg_inf(a) for a in operands):
                self._flag(node, "FL007",
                           "manual -inf masking; express the allowed set as "
                           "a core.constraints penalty (or move it into "
                           "kernels/) so every decode path applies identical "
                           "masking adds")
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def lint_source(src: str, path: str = "<string>") -> list[Violation]:
    """Lint one module's source text; `path` drives rule scoping."""
    per_line, file_wide, bad = _parse_disables(src, path)
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Violation(path, e.lineno or 1, (e.offset or 0) + 1, "FL005",
                          f"syntax error: {e.msg}")]
    visitor = _Visitor(path)
    visitor.visit(tree)
    kept = [v for v in visitor.found
            if v.code not in file_wide
            and v.code not in per_line.get(v.line, ())]
    kept.extend(bad)
    kept.sort(key=lambda v: (v.line, v.col, v.code))
    return kept


def lint_file(path: str | pathlib.Path) -> list[Violation]:
    p = pathlib.Path(path)
    return lint_source(p.read_text(encoding="utf-8"), str(p))


def _iter_py(paths: Iterable[str | pathlib.Path]) -> Iterator[pathlib.Path]:
    for path in paths:
        p = pathlib.Path(path)
        if p.is_dir():
            yield from sorted(q for q in p.rglob("*.py")
                              if "__pycache__" not in q.parts)
        else:
            yield p


def lint_paths(paths: Iterable[str | pathlib.Path]
               ) -> tuple[list[Violation], int]:
    """Lint files/directories; returns (violations, files checked)."""
    violations: list[Violation] = []
    n_files = 0
    for p in _iter_py(paths):
        n_files += 1
        violations.extend(lint_file(p))
    return violations, n_files
