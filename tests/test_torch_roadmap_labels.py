"""The port's refusals name ROADMAP.md items by their labels (A.n for queue
A, Bn for queue B).  Every label a source of pyro2_tpu_torch cites is one
ROADMAP.md defines, every parenthesised "(ROADMAP.md ...)" citation names
one, and the particles and runtime-visualisation refusals of each solver
name A.17 and A.13.  Runs on the CPU: nothing is compiled."""

import pathlib
import re

import pytest

import pyro2_tpu_torch
from pyro2_tpu_torch import Pyro

PORT = pathlib.Path(pyro2_tpu_torch.__file__).parent
ROADMAP = PORT.parent / "ROADMAP.md"
LABEL = re.compile(r"\b(A\.\d+|B\d+)\b")


def _defined():
    """The labels ROADMAP.md defines: those that open a list entry or a
    bold item heading ("- A.6: ...", "1. **A.7 + ...", "- **B1 — ...")."""
    text = ROADMAP.read_text()
    return set(re.findall(r"^\s*(?:-|\d+\.)\s+(?:\*\*)?(A\.\d+|B\d+)\b",
                          text, re.MULTILINE))


def _sources():
    return sorted(p for p in PORT.rglob("*")
                  if p.suffix in (".py", ".cu", ".cuh")
                  and "_build" not in p.parts)


def test_every_cited_label_is_defined():
    """Each label in the port's sources is defined in ROADMAP.md, and no
    source cites an item by its position in a queue ("queue A item 9"),
    which moves when the queue is reordered."""
    defined = _defined()
    assert {"A.13", "A.15", "A.17", "A.20", "A.22", "A.26",
            "A.27"} <= defined
    cited = {}
    for path in _sources():
        text = path.read_text()
        assert not re.search(r"queue [AB] item", text), path
        for label in LABEL.findall(text):
            cited.setdefault(label, []).append(path.relative_to(PORT))
    assert cited
    missing = {k: v for k, v in cited.items() if k not in defined}
    assert not missing, missing


def test_every_roadmap_citation_names_a_label():
    """Every parenthesised citation of ROADMAP.md in the port names a label
    (or takes one from a constant that does: `{item}`, `{MOL_ITEM}`), and
    each module-level *_ITEM constant names one."""
    for path in _sources():
        # join implicitly concatenated string literals
        text = re.sub(r'"\s*\n\s*f?"', "", path.read_text())
        for m in re.finditer(r"\(ROADMAP\.md([^)]*)\)", text):
            body = m.group(1)
            assert LABEL.search(body) or "{" in body, (path, m.group(0))
        for m in re.finditer(r"^(\w+_ITEM) = \(?\s*\"([^\"]*)\"", text,
                             re.MULTILINE):
            assert LABEL.match(m.group(2)), (path, m.group(1))


# the solvers whose initialize refuses particles, and a problem of each
PARTICLES = [("compressible", "quad"), ("compressible_rk", "quad"),
             ("swe", "quad"), ("incompressible", "shear"),
             ("burgers", "tophat"), ("burgers_viscous", "tophat"),
             ("incompressible_viscous", "cavity"), ("advection", "smooth"),
             ("advection_nonuniform", "slotted"), ("advection_rk", "smooth"),
             ("advection_fv4", "smooth"), ("advection_weno", "smooth"),
             ("compressible_react", "flame")]
# the solvers whose dovis refuses runtime visualisation
DOVIS = ["compressible", "diffusion", "incompressible", "swe", "lm_atm",
         "compressible_rk", "burgers", "burgers_viscous",
         "incompressible_viscous", "advection", "advection_nonuniform",
         "advection_rk", "advection_fv4", "advection_weno",
         "compressible_react"]


@pytest.mark.parametrize("solver,problem", PARTICLES)
def test_particles_refusal_names_a17(solver, problem):
    p = Pyro(solver, device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.17"):
        p.initialize_problem(problem, inputs_dict={
            "mesh.nx": 8, "mesh.ny": 8, "particles.do_particles": 1})


@pytest.mark.parametrize("solver", DOVIS)
def test_dovis_refusal_names_a13(solver):
    import importlib

    sim = importlib.import_module(
        f"pyro2_tpu_torch.solvers.{solver}.simulation").Simulation
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.13"):
        sim.dovis(None)


def test_burgers_base_refusals_name_their_labels():
    """The Burgers base class, under burgers, burgers_viscous and the
    incompressible solvers, refuses particles and dovis the same way."""
    from pyro2_tpu_torch.solvers.burgers.simulation import Simulation

    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.13"):
        Simulation.dovis(None)
    src = (PORT / "solvers" / "burgers" / "simulation.py").read_text()
    assert re.search(r"particles wait .*\(ROADMAP\.md \"\s*\"A\.17\)",
                     src, re.DOTALL)
