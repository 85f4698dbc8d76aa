"""Member-level parity of the port with the JAX package: for every module
of `deeplearning4j_tpu/`, every public class and function it defines has
a counterpart of the same name in the port's module of the same path, and
every public attribute of such a class (inherited ones included, as
`dir()` lists them) exists on the port's class. One case per JAX module.

EXEMPT lists the names the port deliberately lacks, each with its reason:
they are JAX tracing hooks whose torch counterparts exist under other
names.
"""

import importlib
import inspect
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "deeplearning4j_tpu"
PORT_PKG = "deeplearning4j_tpu_torch"

_HOOK = "a JAX tracing hook; the port's counterpart is {}"
EXEMPT = {
    ("stats.listener", "jnp_array"):
        _HOOK.format("none needed: it builds a jnp array, and the port's "
                     "listeners take torch tensors and numpy arrays"),
    ("observability.perf", "extract_cost"):
        _HOOK.format("StepProgram.register_perf (it reads XLA's cost "
                     "analysis of a compiled program)"),
    ("observability.perf", "CostModel.register_compiled"):
        _HOOK.format("StepProgram.register_perf"),
    ("observability.perf", "CostModel.register_jit_entry"):
        _HOOK.format("StepProgram.register_perf"),
    ("analysis.jit_lint", "JitSite"):
        _HOOK.format("the capture roots of analysis/jit_lint.py "
                     "(CUDA-graph captures, not jax.jit sites)"),
    ("analysis.jit_lint", "collect_jit_sites"):
        _HOOK.format("analysis/jit_lint.py build_captured"),
    ("analysis.program_lint", "ProgramRecord.compile"):
        _HOOK.format("ProgramRecord.fn, called once under the recorder "
                     "(nothing is lowered or compiled)"),
    ("analysis.program_lint", "ProgramRecord.donate_argnums"):
        _HOOK.format("ProgramRecord.inplace_argnums"),
    ("analysis.program_lint", "ProgramRecord.static_argnums"):
        _HOOK.format("ProgramRecord.example_args, recorded as called"),
}


def _jax_modules():
    base = os.path.join(ROOT, JAX_PKG)
    out = []
    for dirpath, _, files in os.walk(base):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), base)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            out.append(".".join(parts))
    return sorted(out)


MODULES = _jax_modules()


def missing_members(mod: str):
    """The public names the JAX module `mod` (relative to the package)
    defines that its port counterpart lacks: "Name" for a class or
    function, "Class.attr" for a member."""
    jname = ".".join(p for p in (JAX_PKG, mod) if p)
    pname = ".".join(p for p in (PORT_PKG, mod) if p)
    jm = importlib.import_module(jname)
    pm = importlib.import_module(pname)
    missing = []
    for name, obj in vars(jm).items():
        if name.startswith("_") or not (inspect.isclass(obj)
                                        or inspect.isfunction(obj)):
            continue
        if getattr(obj, "__module__", None) != jname:
            continue
        if not hasattr(pm, name):
            missing.append(name)
            continue
        if inspect.isclass(obj):
            twin = getattr(pm, name)
            missing += [f"{name}.{a}" for a in dir(obj)
                        if not a.startswith("_") and not hasattr(twin, a)]
    return missing


@pytest.mark.parametrize("mod", MODULES, ids=lambda m: m or "<package>")
def test_port_module_has_every_public_member(mod):
    missing = [n for n in missing_members(mod) if (mod, n) not in EXEMPT]
    assert not missing, (f"{PORT_PKG}.{mod} lacks public members of "
                         f"{JAX_PKG}.{mod}: {missing}")


def test_exempt_names_are_real_jax_members_the_port_lacks():
    """Every exemption names a member the JAX module has and the port's
    lacks, with its reason: a stale entry would hide nothing."""
    for (mod, name), reason in EXEMPT.items():
        assert reason
        assert name in missing_members(mod), (mod, name)
