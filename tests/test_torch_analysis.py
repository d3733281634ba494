"""Parity of the port's analysis CLIs (pyro2_tpu_torch/analysis/) with the
JAX package's (pyro2_tpu/analysis/).

Both packages read the same files, written by the JAX package: its goldens
(sod_x, smooth, gaussian, shear, the cavity) and, in a temporary
directory, a dam break after 10 steps and the initial Sedov blast and
smooth-advection states at three resolutions.  The port reads them in
float64 on the CPU (`--device cpu`).  Each module's numbers -- exact
solutions, errors, profiles, convergence rates, the arrays handed to the
plots -- equal the JAX module's at rtol 1e-12, and the text each main()
prints is the JAX main()'s.  The plotting modules write their image under
tmp_path (with matplotlib, which the GPU machine lacks)."""

import importlib
import re
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "pyro2_tpu" / "solvers"
SOD = GOLDEN / "compressible" / "tests" / "sod_x_0076.h5"
SMOOTH = GOLDEN / "advection" / "tests" / "smooth_0040.h5"
GAUSSIAN = GOLDEN / "diffusion" / "tests" / "gaussian_0164.h5"
SHEAR = GOLDEN / "incompressible" / "tests" / "shear_128_0023.h5"
CAVITY = GOLDEN / "incompressible_viscous" / "tests" / \
    "cavity_n64_Re400_0025.h5"
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def _mods(name):
    return (importlib.import_module(f"pyro2_tpu_torch.analysis.{name}"),
            importlib.import_module(f"pyro2_tpu.analysis.{name}"))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """JAX-written outputs: the dam break (inputs.dam.x at 64 x 10, 10
    steps), the initial Sedov blast at 32^2 and smooth advection at 64^2,
    32^2 and 16^2."""
    from pyro2_tpu import Pyro as JPyro

    d = tmp_path_factory.mktemp("analysis")
    out = {}
    p = JPyro("swe")
    p.initialize_problem("dam", inputs_file="inputs.dam.x", inputs_dict={
        "mesh.nx": 64, "driver.max_steps": 10})
    p.run_sim()
    out["dam"] = str(d / "dam_0010.h5")
    p.sim.write(out["dam"])
    p = JPyro("compressible")
    p.initialize_problem("sedov", inputs_dict={"mesh.nx": 32,
                                               "mesh.ny": 32})
    out["sedov"] = str(d / "sedov_0000.h5")
    p.sim.write(out["sedov"])
    for n in (64, 32, 16):
        p = JPyro("advection")
        p.initialize_problem("smooth", inputs_dict={"mesh.nx": n,
                                                    "mesh.ny": n})
        out[f"smooth{n}"] = str(d / f"smooth_{n}.h5")
        p.sim.write(out[f"smooth{n}"])
    return out


def _read(path):
    from pyro2_tpu.util import io_pyro as jio
    from pyro2_tpu_torch.analysis import read

    return read(path, "cpu"), jio.read(str(path))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float), rtol=1e-12,
                               atol=0)


def _printed(name, argv, capsys, monkeypatch):
    """(port's stdout, JAX's stdout) of each main() on argv; the port's
    reads on the CPU."""
    tmod, jmod = _mods(name)
    capsys.readouterr()
    tmod.main(["--device", "cpu", *argv])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", [name, *argv])
    jmod.main()
    return port, capsys.readouterr().out


def _same_numbers(port, jax_text):
    """The two outputs say the same with numbers equal at rtol 1e-12."""
    assert NUMBER.sub("#", port) == NUMBER.sub("#", jax_text)
    _close([float(x) for x in NUMBER.findall(port)],
           [float(x) for x in NUMBER.findall(jax_text)])


@pytest.mark.parametrize("case", [
    (1.0, 0.0, 1.0, 0.125, 0.0, 0.1, 1.4, 0.2),      # Sod
    (1.0, -2.0, 0.4, 1.0, 2.0, 0.4, 1.4, 0.15),     # two rarefactions
    (1.0, 0.0, 1000.0, 1.0, 0.0, 0.01, 1.4, 0.012),  # a strong shock
    (5.99924, 19.5975, 460.894, 5.99242, -6.19633, 46.095, 1.4,
     0.035)])                                       # two shocks
def test_exact_riemann(case):
    tmod, jmod = _mods("exact_riemann")
    *state, gamma, t = case
    x = np.linspace(0.0, 1.0, 300)
    for a, b in zip(tmod.exact_riemann(*state, gamma=gamma, t=t, x=x),
                    jmod.exact_riemann(*state, gamma=gamma, t=t, x=x)):
        _close(a, b)
    for a, b in zip(tmod.sod_exact(t=t, n=128), jmod.sod_exact(t=t, n=128)):
        _close(a, b)


def test_convergence(files, capsys, monkeypatch):
    tmod, jmod = _mods("convergence")
    tf, jf = _read(files["smooth64"])
    tc, jc = _read(files["smooth32"])
    got = tmod.compare(tf.cc_data, tc.cc_data, "density", 2)
    _close(got, jmod.compare(jf.cc_data, jc.cc_data, "density", 2))
    assert got[0] > 0.0
    _same_numbers(*_printed("convergence", [files["smooth32"],
                                            files["smooth16"]],
                            capsys, monkeypatch))


def test_smooth_error(capsys, monkeypatch):
    port, jax_text = _printed("smooth_error", [str(SMOOTH)], capsys,
                              monkeypatch)
    _same_numbers(port, jax_text)
    assert port.split()[0] == "32"


def test_sod_compare(tmp_path, capsys, monkeypatch):
    tmod, jmod = _mods("sod_compare")
    ts, js = _read(SOD)
    for a, b in zip(tmod.extract_profile(ts.cc_data),
                    jmod.extract_profile(js.cc_data)):
        _close(a, b)
    _, exact, errors = tmod.compare_to_exact(ts.cc_data)
    for a, b in zip(exact, jmod.sod_exact(t=js.cc_data.t, n=512)):
        _close(a, b)
    assert [e[0] for e in errors] == ["rho", "u", "p"]
    port, jax_text = _printed("sod_compare", [str(SOD)], capsys,
                              monkeypatch)
    assert port == jax_text
    pytest.importorskip("matplotlib")
    png = tmp_path / "sod.png"
    tmod.main(["--device", "cpu", str(SOD), str(png)])
    assert png.stat().st_size > 0


def test_dam_compare(files, tmp_path, capsys, monkeypatch):
    tmod, jmod = _mods("dam_compare")
    x = np.linspace(0.0, 1.0, 101)
    for a, b in zip(tmod.dam_exact(1.0, 0.1, 1.0, 0.2, 0.5, x),
                    jmod.dam_exact(1.0, 0.1, 1.0, 0.2, 0.5, x)):
        _close(a, b)
    ts, js = _read(files["dam"])
    coord, h, u, h_e, u_e = tmod.compare_to_exact(ts.cc_data)
    myg = js.cc_data.grid
    jj = myg.ny // 2 + myg.ng
    hj = np.asarray(js.cc_data.get_var("height"))[myg.ilo:myg.ihi + 1, jj]
    _close(h, hj)
    _close(h_e, jmod.dam_exact(hj.max(), hj.min(), js.cc_data.get_aux("g"),
                               js.cc_data.t, 0.5 * (myg.xmin + myg.xmax),
                               coord)[0])
    assert np.abs(h - h_e).max() > 0.0
    port, jax_text = _printed("dam_compare", [files["dam"]], capsys,
                              monkeypatch)
    assert port == jax_text
    pytest.importorskip("matplotlib")
    png = tmp_path / "dam.png"
    tmod.main(["--device", "cpu", files["dam"], str(png)])
    assert png.stat().st_size > 0


def test_sedov_compare(files, tmp_path, capsys, monkeypatch):
    tmod, jmod = _mods("sedov_compare")
    ts, js = _read(files["sedov"])
    for a, b in zip(tmod.radial_profile(ts.cc_data),
                    jmod.radial_profile(js.cc_data)):
        _close(a, b)
    port, jax_text = _printed("sedov_compare", [files["sedov"]], capsys,
                              monkeypatch)
    assert port == jax_text
    # a made-up exact table: (r/r_s, rho/rho_s) falling off inside
    table = tmp_path / "exact.txt"
    s = np.linspace(0.0, 1.2, 25)
    np.savetxt(table, np.stack([s, np.exp(-3.0 * (1.0 - s) ** 2),
                                s, s], axis=1))
    port, jax_text = _printed("sedov_compare", [files["sedov"], str(table)],
                              capsys, monkeypatch)
    assert port == jax_text and "inside shock" in port


def test_gauss_diffusion_compare(capsys, monkeypatch):
    port, jax_text = _printed("gauss_diffusion_compare", [str(GAUSSIAN)],
                              capsys, monkeypatch)
    _same_numbers(port, jax_text)


def test_incomp_converge_error(capsys, monkeypatch):
    port, jax_text = _printed("incomp_converge_error", [str(SHEAR)], capsys,
                              monkeypatch)
    _same_numbers(port, jax_text)
    assert port.count("L2 error") == 2


def test_incomp_viscous_converge_error(capsys, monkeypatch):
    tmod, jmod = _mods("incomp_viscous_converge_error")
    _close(tmod.get_errors(str(CAVITY), "cpu"), jmod.get_errors(str(CAVITY)))
    _same_numbers(*_printed("incomp_viscous_converge_error", [str(CAVITY)],
                            capsys, monkeypatch))


def test_convergence_plot(files, tmp_path, capsys, monkeypatch):
    tmod, jmod = _mods("convergence_plot")
    names = [files[f"smooth{n}"] for n in (64, 32, 16)]
    nxs, errors = tmod.convergence_errors(names, device="cpu")
    jnxs, jerrors = jmod.convergence_errors(names)
    assert nxs == jnxs == [32, 16]
    _close(errors, jerrors)
    capsys.readouterr()
    tmod.convergence_plot(nxs, errors)
    port = capsys.readouterr().out
    jmod.convergence_plot(jnxs, jerrors)
    assert port == capsys.readouterr().out
    with pytest.raises(ValueError, match="differ by x2"):
        tmod.convergence_errors(names[::2], device="cpu")
    pytest.importorskip("matplotlib")
    pdf = tmp_path / "conv.pdf"
    tmod.main(["--device", "cpu", *names, "-o", str(pdf)])
    assert pdf.stat().st_size > 0


@pytest.fixture
def shown(monkeypatch):
    """The arrays the plots hand to imshow, in call order."""
    plt = pytest.importorskip("matplotlib.pyplot")
    seen = []
    imshow = plt.imshow

    def record(X, *a, **kw):
        seen.append(np.array(X, dtype=float))
        return imshow(X, *a, **kw)

    monkeypatch.setattr(plt, "imshow", record)
    yield seen
    plt.close("all")


@pytest.mark.parametrize("path,variable,log", [
    (SOD, "density", False), (SHEAR, "x-velocity", False),
    (GAUSSIAN, "phi", True)])
def test_plotvar(path, variable, log, shown, tmp_path, monkeypatch):
    tmod, jmod = _mods("plotvar")
    flags = ["--log"] if log else []
    tmod.main(["--device", "cpu", *flags, "-o", str(tmp_path / "t.png"),
               str(path), variable])
    monkeypatch.setattr(sys, "argv", ["plotvar", *flags, "-o",
                                      str(tmp_path / "j.png"), str(path),
                                      variable])
    jmod.main()
    assert len(shown) == 2
    _close(*shown)
    assert (tmp_path / "t.png").stat().st_size > 0


@pytest.mark.parametrize("path,variable", [(SHEAR, "vort"),
                                           (SOD, "density")])
def test_plotcompact(path, variable, shown, tmp_path):
    tmod, jmod = _mods("plotcompact")
    tmod.makeplot(str(path), variable, str(tmp_path / "t.png"),
                  device="cpu")
    jmod.makeplot(str(path), variable, str(tmp_path / "j.png"))
    assert len(shown) == 2
    _close(*shown)
    assert (tmp_path / "t.png").stat().st_size > 0


def test_plot_thumbnail(shown, tmp_path, monkeypatch):
    tmod, jmod = _mods("plot_thumbnail")
    tmod.main(["--device", "cpu", str(GAUSSIAN), "phi",
               str(tmp_path / "t.png")])
    monkeypatch.setattr(sys, "argv", ["plot_thumbnail", str(GAUSSIAN),
                                      "phi", str(tmp_path / "j.png")])
    jmod.main()
    assert len(shown) == 2
    _close(*shown)
    assert (tmp_path / "t.png").stat().st_size > 0

