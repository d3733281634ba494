"""The port's refusals name ROADMAP.md items by their labels (A.n for queue
A, Bn for queue B).  Every label a source of pyro2_tpu_torch cites is one
ROADMAP.md defines, and every parenthesised "(ROADMAP.md ...)" citation
names one.  Each solver that refused particles before they were ported
(A.17) now advances them as the JAX package does, and each that refused
runtime visualisation before it was ported (A.13) now draws.  Runs on
the CPU: nothing is compiled."""

import pathlib
import re

import numpy as np
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
    assert {"A.13", "A.15", "A.20", "A.22", "A.26", "A.27",
            "A.28"} <= defined
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


# the solvers whose initialize refused particles before A.17, and a
# problem of each
PARTICLES = [("compressible", "quad"), ("compressible_rk", "quad"),
             ("swe", "quad"), ("incompressible", "shear"),
             ("burgers", "tophat"), ("burgers_viscous", "tophat"),
             ("incompressible_viscous", "cavity"), ("advection", "smooth"),
             ("advection_nonuniform", "slotted"), ("advection_rk", "smooth"),
             ("advection_fv4", "smooth"), ("advection_weno", "smooth"),
             ("compressible_react", "flame")]
# beside the cavity, whose moving lid is no particle boundary
PARTICLES_MORE = [("incompressible_viscous", "shear")]
# the solvers whose dovis refused runtime visualisation before A.13, and a
# problem of each
DOVIS = {"compressible": "quad", "diffusion": "gaussian",
         "incompressible": "shear", "swe": "quad", "lm_atm": "bubble",
         "compressible_rk": "quad", "burgers": "tophat",
         "burgers_viscous": "tophat", "incompressible_viscous": "cavity",
         "advection": "smooth", "advection_nonuniform": "slotted",
         "advection_rk": "smooth", "advection_fv4": "smooth",
         "advection_weno": "smooth", "compressible_react": "flame"}


# the JAX incompressible solvers ask their data for a derived "velocity"
# it lacks (a KeyError): there the JAX run steps without particles and a
# JAX Particles advances with the projected velocities after each step,
# which is what the port's evolve does (ROADMAP.md section C.4)
DERIVED_VELOCITY_MISSING = ("incompressible", "incompressible_viscous")


@pytest.mark.parametrize("solver,problem", PARTICLES + PARTICLES_MORE)
def test_particles_match_jax(solver, problem):
    """Random particles (numpy's global generator, one seed for both
    packages) after 3 steps at 16x16: positions at rtol 1e-12, `active`
    equal.  The cavity's moving lid is no boundary the particles know:
    both packages' Particles raise at the first advance."""
    from pyro2_tpu.particles.particles import Particles as JParticles
    from pyro2_tpu.pyro_sim import Pyro as JPyro
    from pyro2_tpu.simulation_null import bc_setup

    inputs = {"mesh.nx": 16, "mesh.ny": 16, "particles.do_particles": 1,
              "particles.particle_generator": "random",
              "particles.n_particles": 40}
    np.random.seed(5)
    t = Pyro(solver, device="cpu")
    t.initialize_problem(problem, inputs_dict=dict(inputs))
    oracle = solver in DERIVED_VELOCITY_MISSING
    if oracle:
        inputs["particles.do_particles"] = 0
    np.random.seed(5)
    j = JPyro(solver)
    j.initialize_problem(problem, inputs_dict=inputs)
    if oracle:
        np.random.seed(5)
        jp = JParticles(j.sim.cc_data, bc_setup(j.rp)[0], 40, "random")
    else:
        jp = j.sim.particles
    if problem == "cavity":
        with pytest.raises(RuntimeError,
                           match="moving_lid invalid BC for particles"):
            t.single_step()
        j.single_step()
        with pytest.raises(RuntimeError,
                           match="moving_lid invalid BC for particles"):
            jp.update_particles(j.sim.dt,
                                j.sim.cc_data.get_var("x-velocity"),
                                j.sim.cc_data.get_var("y-velocity"))
        return
    for _ in range(3):
        t.single_step()
        j.single_step()
        if oracle:
            jp.update_particles(j.sim.dt,
                                j.sim.cc_data.get_var("x-velocity"),
                                j.sim.cc_data.get_var("y-velocity"))
    tp = t.sim.particles
    assert tp.positions.shape == (40, 2)
    np.testing.assert_allclose(tp.positions.numpy(),
                               np.asarray(jp.positions), rtol=1e-12)
    assert np.array_equal(tp.active.numpy(), np.asarray(jp.active))
    # they moved
    assert not np.array_equal(tp.positions.numpy(),
                              tp.init_positions.numpy())


@pytest.mark.parametrize("solver", sorted(DOVIS))
def test_dovis_refusal_names_a13(solver):
    """A.13 is done: no solver's dovis refuses (none cites A.13 any more).
    Each draws its fields into figure 1 from a 16x16 run of the port alone
    on the CPU, every image finite (tests/test_torch_plot.py holds the
    drawings to the JAX package's)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p = Pyro(solver, device="cpu")
    p.initialize_problem(DOVIS[solver], inputs_dict={"mesh.nx": 16,
                                                     "mesh.ny": 16})
    p.single_step()
    plt.figure(num=1, clear=True)
    try:
        p.sim.dovis()
        images = [im.get_array() for ax in plt.figure(1).axes
                  for im in ax.get_images()]
    finally:
        plt.close("all")
    assert images and all(np.isfinite(np.asarray(a)).all() for a in images)
    source = PORT / "solvers" / solver / "simulation.py"
    assert "A.13" not in source.read_text()


def test_burgers_base_refusals_name_their_labels():
    """No solver refuses particles any more (A.17 is done), nor runtime
    visualisation (A.13 is done): no source cites either label."""
    for path in _sources():
        text = re.sub(r'"\s*\n\s*f?"', "", path.read_text())
        assert not re.search(r"particles wait", text), path
        assert "A.17" not in text, path
        assert "A.13" not in text, path
        assert not re.search(r"visualization waits", text), path
