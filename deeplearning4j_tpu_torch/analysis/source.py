"""Shared AST plumbing for the static passes (counterpart of
deeplearning4j_tpu/analysis/source.py, kept as it is).

Everything here is stdlib-only and import-free with respect to the
analyzed code: files are *parsed*, never executed, so
`tools/analyze_torch.py` runs in well under a second with no torch (or
any other dependency) in the process.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional

from deeplearning4j_tpu_torch.analysis.findings import parse_pragmas


@dataclass
class SourceFile:
    path: Path
    rel: str                       # repo-relative posix path
    text: str
    tree: ast.Module
    allow: Dict[int, set] = field(default_factory=dict)
    # node -> enclosing function qualname ("" at module level)
    _qualnames: Dict[int, str] = field(default_factory=dict)
    # id(node) -> every node under it (ast.walk order), filled on demand:
    # each pass walks the same trees many times
    _walks: Dict[int, list] = field(default_factory=dict)
    # id(node) -> its parent node
    parents: Dict[int, ast.AST] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: Path, root: Path) -> Optional["SourceFile"]:
        try:
            text = path.read_text()
            tree = ast.parse(text, filename=str(path))
        except (SyntaxError, UnicodeDecodeError, OSError):
            return None
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        sf = cls(path=path, rel=rel, text=text, tree=tree,
                 allow=parse_pragmas(text))
        sf._annotate_qualnames()
        return sf

    # ---------------------------------------------------------- helpers
    def _annotate_qualnames(self) -> None:
        """One traversal: every node's enclosing qualname, its parent,
        and the node list of the module and of each function (which
        `walk` then serves without walking again)."""
        module = [self.tree]
        fdefs = (ast.FunctionDef, ast.AsyncFunctionDef)
        # (node, qualname stack, open function node lists)
        todo = [(self.tree, (), (module,))]
        while todo:
            node, stack, lists = todo.pop()
            for child in ast.iter_child_nodes(node):
                self.parents[id(child)] = node
                for lst in lists:
                    lst.append(child)
                if isinstance(child, fdefs):
                    inner = stack + (child.name,)
                    self._qualnames[id(child)] = ".".join(inner)
                    own = [child]
                    self._walks[id(child)] = own
                    todo.append((child, inner, lists + (own,)))
                elif isinstance(child, ast.ClassDef):
                    todo.append((child, stack + (child.name,), lists))
                else:
                    self._qualnames[id(child)] = ".".join(stack)
                    todo.append((child, stack, lists))
        self._walks[id(self.tree)] = module

    def qualname_of(self, node) -> str:
        return self._qualnames.get(id(node), "")

    def walk(self, node=None) -> list:
        """Every node under `node` (default: the module) — the nodes of
        `ast.walk(node)`, computed once."""
        node = self.tree if node is None else node
        out = self._walks.get(id(node))
        if out is None:
            out = self._walks[id(node)] = list(ast.walk(node))
        return out

    def functions(self) -> Iterator[ast.FunctionDef]:
        for node in self.walk():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield node


def iter_py_files(pkg_dir: Path) -> List[Path]:
    return sorted(p for p in pkg_dir.rglob("*.py")
                  if "__pycache__" not in p.parts)


def load_sources(pkg_dir: Path, root: Path,
                 only: Optional[set] = None) -> List[SourceFile]:
    """Parse every .py file under `pkg_dir`. `only` (repo-relative
    posix paths) restricts the list — used by --diff mode."""
    out = []
    for p in iter_py_files(pkg_dir):
        sf = SourceFile.parse(p, root)
        if sf is None:
            continue
        if only is not None and sf.rel not in only:
            continue
        out.append(sf)
    return out


# ------------------------------------------------------- name helpers
def call_name(node: ast.Call) -> str:
    """Last identifier of the callee: foo() -> foo, a.b.foo() -> foo."""
    f = node.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return ""


def dotted(node) -> str:
    """Best-effort dotted name of an expression (torch.cuda.graph,
    self._lock)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return dotted(node.func) + "()"
    return ""


def const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
