"""Visualization of the PyTorch port (pyro2_tpu_torch/plot.py,
util/plot_tools.py, every solver's dovis, incompressible_viscous's
plot_cavity) against the JAX package's, on the CPU with matplotlib's Agg
backend (the GPU machine has no matplotlib).

Each solver's dovis draws, from the same JAX-written 16x16 one-step file
read by each package's own io_pyro.read (the port's in float64 on the
CPU), every image at rtol 1e-12 of the JAX package's, on as many axes
with the same titles and the same time stamp.  Neither package reads a
compressible_react file back (both look for a compressible_react.BC
module that neither has), so that solver's two simulations draw the
state of the JAX run's step, copied into the port's own run.  plot.py
round-trips a Cartesian and a spherical file to non-empty PNGs, and the
runtime parameters write their Sphinx tables, as the JAX package's
tests/test_plot_roundtrip.py checks."""

import os

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

import pyro2_tpu.mesh.boundary as jbnd  # noqa: E402
import pyro2_tpu_torch.mesh.boundary as bnd  # noqa: E402

# a problem of each solver whose dovis the port has, the 15 Pyro() solvers
# whose dovis draws something
DOVIS = {"compressible": "quad", "diffusion": "gaussian",
         "incompressible": "shear", "swe": "quad", "lm_atm": "bubble",
         "compressible_rk": "quad", "burgers": "tophat",
         "burgers_viscous": "tophat", "incompressible_viscous": "cavity",
         "advection": "smooth", "advection_nonuniform": "slotted",
         "advection_rk": "smooth", "advection_fv4": "smooth",
         "advection_weno": "smooth", "compressible_react": "flame"}


@pytest.fixture(autouse=True)
def _bc_registries():
    """Restore both packages' BC registries (module-level dicts that a
    read fills) after each test, and close the figures."""
    saved = [(m.bc_solid.copy(), m.ext_bcs.copy()) for m in (jbnd, bnd)]
    yield
    plt.close("all")
    for m, (solid, ext) in zip((jbnd, bnd), saved):
        m.bc_solid.clear()
        m.bc_solid.update(solid)
        m.ext_bcs.clear()
        m.ext_bcs.update(ext)


def _jax_run(solver, problem, inputs=None):
    """A JAX run of 16x16 cells after one step."""
    from pyro2_tpu.pyro_sim import Pyro as JPyro

    p = JPyro(solver)
    p.initialize_problem(problem, inputs_dict={"mesh.nx": 16, "mesh.ny": 16,
                                               **(inputs or {})})
    p.single_step()
    return p


def _jax_file(solver, problem, path, inputs=None):
    """A JAX-written output after one step of a 16x16 run."""
    p = _jax_run(solver, problem, inputs)
    p.sim.write(str(path))
    return str(path) + ".h5"


def _drawn(sim):
    """dovis of sim into a fresh figure 1: (each axes' title, images' and
    meshes' arrays), the figure's texts."""
    plt.figure(num=1, clear=True)
    sim.dovis()
    fig = plt.figure(1)
    axes = [(ax.get_title(),
             [np.asarray(im.get_array()) for im in ax.get_images()] +
             [np.asarray(c.get_array()) for c in ax.collections
              if hasattr(c, "get_coordinates")])
            for ax in fig.axes]
    return axes, [t.get_text() for t in fig.texts]


def _same_drawing(port, jax):
    (p_axes, p_texts), (j_axes, j_texts) = port, jax
    assert len(p_axes) == len(j_axes)
    assert [t for t, _ in p_axes] == [t for t, _ in j_axes]
    assert p_texts == j_texts
    drawn = 0
    for (_, p_arrays), (_, j_arrays) in zip(p_axes, j_axes):
        assert len(p_arrays) == len(j_arrays)
        for a, b in zip(p_arrays, j_arrays):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
            drawn += 1
    assert drawn > 0


@pytest.mark.parametrize("solver", sorted(DOVIS))
def test_dovis_matches_jax(solver, tmp_path):
    import torch

    from pyro2_tpu.util import io_pyro as jio
    from pyro2_tpu_torch import Pyro
    from pyro2_tpu_torch.util import io_pyro

    if solver == "compressible_react":
        j = _jax_run(solver, DOVIS[solver])
        jax = _drawn(j.sim)
        p = Pyro(solver, device="cpu")
        p.initialize_problem(DOVIS[solver], inputs_dict={"mesh.nx": 16,
                                                         "mesh.ny": 16})
        p.sim.cc_data.data = torch.tensor(np.asarray(j.sim.cc_data.data))
        p.sim.cc_data.t, p.sim.n = j.sim.cc_data.t, j.sim.n
        port = p.sim
    else:
        h5 = _jax_file(solver, DOVIS[solver], tmp_path / "out")
        jax = _drawn(jio.read(h5))
        port = io_pyro.read(h5, device="cpu")
    _same_drawing(_drawn(port), jax)


def test_dovis_spherical_matches_jax(tmp_path):
    """The spherical branch of compressible's dovis (the r-theta cells
    projected to x-z, drawn as meshes)."""
    from pyro2_tpu.util import io_pyro as jio
    from pyro2_tpu_torch.util import io_pyro

    h5 = _jax_file("compressible", "test", tmp_path / "sph", SPHERICAL)
    jax = _drawn(jio.read(h5))
    _same_drawing(_drawn(io_pyro.read(h5, device="cpu")), jax)
    assert not any(ax.get_images() for ax in plt.figure(1).axes)


def _port_file(solver, problem, path, inputs):
    from pyro2_tpu_torch import Pyro

    p = Pyro(solver, device="cpu")
    p.initialize_problem(problem, inputs_dict=inputs)
    p.single_step()
    p.sim.write(str(path))
    return str(path) + ".h5"


SPHERICAL = {"mesh.grid_type": "SphericalPolar", "mesh.nx": 8, "mesh.ny": 8,
             "mesh.xmin": 1.0, "mesh.xmax": 2.0, "mesh.ymin": 0.3,
             "mesh.ymax": 1.3, "mesh.xlboundary": "outflow",
             "mesh.xrboundary": "outflow", "compressible.riemann": "CGF",
             "driver.tmax": 1.e-5}


def test_plot_roundtrip_cartesian(tmp_path):
    from pyro2_tpu_torch.plot import makeplot

    h5 = _port_file("advection", "tophat", tmp_path / "plotme", {
        "mesh.nx": 16, "mesh.ny": 16, "driver.tmax": 0.05})
    png = str(tmp_path / "out.png")
    makeplot(h5, png, device="cpu")
    assert os.path.getsize(png) > 0


def test_plot_roundtrip_spherical(tmp_path):
    """The spherical dovis branch round-trips from a stored file (the grid's
    coord_type and the solver's dovis through io_pyro.read)."""
    from pyro2_tpu_torch.plot import makeplot

    h5 = _port_file("compressible", "test", tmp_path / "plotme", SPHERICAL)
    png = str(tmp_path / "out_sph.png")
    makeplot(h5, png, device="cpu")
    assert os.path.getsize(png) > 0


def test_plot_main_names_the_png_after_the_file(tmp_path, monkeypatch):
    from pyro2_tpu_torch import plot

    h5 = _port_file("advection", "tophat", tmp_path / "plotme", {
        "mesh.nx": 16, "mesh.ny": 16, "driver.tmax": 0.05})
    monkeypatch.chdir(tmp_path)
    plot.main(["--device", "cpu", "-W", "4", "-H", "3", h5])
    assert os.path.getsize(tmp_path / "plotme.png") > 0


def test_sphinx_tables(tmp_path):
    from pyro2_tpu.pyro_sim import Pyro as JPyro
    from pyro2_tpu_torch import Pyro

    p = Pyro("compressible", device="cpu")
    out = str(tmp_path / "params-sphinx.inc")
    p.rp.print_sphinx_tables(out)
    text = open(out).read()
    # one table per section, with grid-table rows carrying the comments
    assert "* section: ``[driver]``" in text
    assert "* section: ``[compressible]``" in text
    assert "``cfl``" in text
    assert text.count("+=") >= 5
    # the JAX package's tables of the same parameters: the same layout,
    # options and values (the port words one description its own way)
    j = str(tmp_path / "jax-sphinx.inc")
    JPyro("compressible").rp.print_sphinx_tables(j)

    def columns(path):
        return [line.split("|")[1:3] if line.startswith("  |") else line
                for line in open(path).read().splitlines()]

    assert columns(out) == columns(j)


def test_plot_cavity_draws_the_jax_arrays(tmp_path):
    """plot_cavity of a JAX-written cavity file: the image of |U| and the
    streamlines' field equal the JAX module's, and the PNG is written."""
    import importlib

    mods = [importlib.import_module(
        f"{pkg}.solvers.incompressible_viscous.problems.plot_cavity")
        for pkg in ("pyro2_tpu_torch", "pyro2_tpu")]
    h5 = _jax_file("incompressible_viscous", "cavity", tmp_path / "cav")
    drawn = []
    for mod, kw in zip(mods, ({"device": "cpu"}, {})):
        png = str(tmp_path / f"cavity_{len(drawn)}.png")
        mod.makeplot(h5, png, 400.0, 1.0, **kw)
        assert os.path.getsize(png) > 0
        fig = plt.gcf()
        ax = fig.axes[0]
        drawn.append((ax.get_title(), np.asarray(ax.get_images()[0]
                                                 .get_array()),
                      len(ax.collections)))
        plt.close("all")
    (pt, pa, pc), (jt, ja, jc) = drawn
    assert pt == jt and "Re = 400" in pt and pc == jc > 0
    np.testing.assert_allclose(pa, ja, rtol=1e-12, atol=0)


def test_vis_dovis_run_saves_each_step(tmp_path, monkeypatch):
    """vis.dovis=1 through Pyro.run_sim: dovis after every step into figure
    1, and with vis.store_images=1 one PNG a step named after the output
    basename."""
    from pyro2_tpu_torch import Pyro

    monkeypatch.chdir(tmp_path)
    p = Pyro("advection", device="cpu")
    p.initialize_problem("smooth", inputs_dict={
        "mesh.nx": 16, "mesh.ny": 16, "driver.max_steps": 2,
        "io.basename": "smooth_"})
    p.rp.set_param("vis.dovis", 1)
    p.rp.set_param("vis.store_images", 1)
    p.dovis = 1
    p.run_sim()
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".png")) \
        == ["smooth_0001.png", "smooth_0002.png"]
    assert plt.figure(1).axes
