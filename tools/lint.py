#!/usr/bin/env python
"""Static lint gate for the repository.

The reference enforced pylint inside its test run (reference
setup.cfg:5 ``addopts = ... --pylint``).  No third-party linter is
available in this image, so this module implements the checks that
matter for this codebase directly on the ``ast``/``tokenize`` level and
is enforced the same way the reference enforced pylint: by a test
(tests/test_lint.py) and a ``make lint`` target.

Checks (codes roughly follow pyflakes/pycodestyle conventions):

- E901  syntax error (file does not parse)
- E501  line longer than 79 characters
- W291  trailing whitespace
- W191  tab indentation
- E722  bare ``except:``
- F401  imported name never used (module scope; ``__init__.py`` re-
        exports are exempt when listed in ``__all__`` or aliased
        ``import x as x``)
- F841  local variable assigned but never used (conservative: simple
        names only, ``_``-prefixed exempt)
- W0102 mutable default argument (list/dict/set literal)
- F822  name listed in ``__all__`` but not defined in the module

Usage: ``python tools/lint.py [paths...]`` (defaults to the package,
``bin``, ``benchmarks``, ``examples``, ``tools``, ``tests`` and the
top-level scripts).
Exits non-zero if any finding is reported.
"""

import ast
import sys
from pathlib import Path

MAX_LINE = 79

DEFAULT_PATHS = ("convex_dim_red_tpu", "bin", "benchmarks", "examples",
                 "tools", "tests", "bench.py", "chip_smoke.py",
                 "__graft_entry__.py")


def _iter_py_files(paths):
    for p in paths:
        p = Path(p)
        if p.is_dir():
            yield from sorted(p.rglob("*.py"))
        elif p.suffix == ".py":
            yield p


def _check_lines(path, source, findings):
    for i, line in enumerate(source.splitlines(), 1):
        if len(line) > MAX_LINE:
            findings.append((path, i, "E501",
                             "line too long (%d > %d)" % (len(line),
                                                          MAX_LINE)))
        if line != line.rstrip():
            findings.append((path, i, "W291", "trailing whitespace"))
        stripped = line.lstrip(" ")
        if stripped.startswith("\t"):
            findings.append((path, i, "W191", "tab indentation"))


class _ImportVisitor(ast.NodeVisitor):
    """Collect module-level imported names and every name usage."""

    def __init__(self):
        self.imports = {}     # name -> (lineno, is_reexport_alias)
        self.used = set()

    def visit_Import(self, node):
        for alias in node.names:
            name = alias.asname or alias.name.split(".")[0]
            self.imports[name] = (node.lineno,
                                  alias.asname == alias.name)
        self.generic_visit(node)

    def visit_ImportFrom(self, node):
        for alias in node.names:
            if alias.name == "*":
                continue
            name = alias.asname or alias.name
            self.imports[name] = (node.lineno,
                                  alias.asname == alias.name)
        self.generic_visit(node)

    def visit_Name(self, node):
        if isinstance(node.ctx, ast.Load):
            self.used.add(node.id)
        self.generic_visit(node)

    def visit_Attribute(self, node):
        self.generic_visit(node)


def _module_all(tree):
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    try:
                        return list(ast.literal_eval(node.value))
                    except (ValueError, TypeError):
                        return None
    return None


def _check_imports(path, tree, findings):
    visitor = _ImportVisitor()
    visitor.visit(tree)
    exported = set(_module_all(tree) or ())
    is_init = path.name == "__init__.py"
    for name, (lineno, reexport) in visitor.imports.items():
        if name.startswith("_") or name in visitor.used:
            continue
        if name in exported or (is_init and reexport):
            continue
        findings.append((path, lineno, "F401",
                         "'%s' imported but unused" % name))


def _check_all_defined(path, tree, findings):
    names = _module_all(tree)
    if not names:
        return
    defined = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    defined.add(t.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                defined.add((alias.asname
                             or alias.name.split(".")[0]))
    for name in names:
        if name not in defined:
            findings.append((path, 1, "F822",
                             "undefined name %r in __all__" % name))


def _check_functions(path, tree, findings):
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            findings.append((path, node.lineno, "E722",
                             "bare 'except:'"))
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for default in (list(node.args.defaults)
                            + [d for d in node.args.kw_defaults if d]):
                if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                    findings.append(
                        (path, default.lineno, "W0102",
                         "mutable default argument in '%s'" % node.name))
            _check_unused_locals(path, node, findings)


def _check_unused_locals(path, func, findings):
    """Conservative F841: plain ``name = ...`` statements in a function
    body whose name is never loaded or re-exported anywhere in the
    function (nested scopes included via the full walk)."""
    assigned = {}
    loaded = set()
    for node in ast.walk(func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not func:
            # Names assigned in nested functions are their business.
            for sub in ast.walk(node):
                if isinstance(sub, ast.Name):
                    loaded.add(sub.id)
            continue
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            if not name.startswith("_"):
                assigned.setdefault(name, node.lineno)
        elif isinstance(node, ast.Name) and not isinstance(node.ctx,
                                                           ast.Store):
            loaded.add(node.id)
        elif isinstance(node, (ast.Global, ast.Nonlocal)):
            loaded.update(node.names)
    for name, lineno in assigned.items():
        if name not in loaded:
            findings.append((path, lineno, "F841",
                             "local variable '%s' assigned but never "
                             "used" % name))


def lint_file(path):
    findings = []
    source = Path(path).read_text()
    _check_lines(path, source, findings)
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as exc:
        findings.append((path, exc.lineno or 1, "E901",
                         "syntax error: %s" % exc.msg))
        return findings
    _check_imports(Path(path), tree, findings)
    _check_all_defined(Path(path), tree, findings)
    _check_functions(Path(path), tree, findings)
    return findings


def lint_paths(paths=DEFAULT_PATHS):
    findings = []
    for f in _iter_py_files(paths):
        findings.extend(lint_file(f))
    return findings


def main(argv=None):
    paths = (argv or sys.argv[1:]) or list(DEFAULT_PATHS)
    findings = lint_paths(paths)
    for path, lineno, code, msg in findings:
        print("%s:%d: %s %s" % (path, lineno, code, msg))
    if findings:
        print("%d finding(s)" % len(findings))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
