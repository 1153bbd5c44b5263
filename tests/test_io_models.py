"""File ingestion against the reference file format + model zoo.

The reference's example-data.xls is not distributed here; the flagship
generator writes the same format (``lisp_mcmc_tpu.flagship``), and the
``example_table_path`` fixture (tests/conftest.py) provides it.
"""

import numpy as np
import pytest

from lisp_mcmc_tpu.io import file_specs, get_filename, read_file_data
from lisp_mcmc_tpu.models import (
    MODEL_REGISTRY,
    damped_sinusoid,
    double_lorentzian_bg,
    example_line,
    gaussian_peak,
    get_model,
    line,
    lorder_mixed_bg,
    polynomial,
    power_law,
    pseudo_voigt,
    stretched_exponential,
)

def test_file_specs_example_data(example_table_path):
    # example-data.xls: tab-separated, 1 header line, 9 columns, 334 rows
    # (SURVEY §0).
    specs = file_specs(example_table_path)
    assert specs["delim"] == "\t"
    assert specs["header_lines"] == 1
    assert specs["columns"] == 9
    assert specs["pages"] == 1


def test_read_file_data_example_data(example_table_path):
    from lisp_mcmc_tpu.data import create_walker_data
    from lisp_mcmc_tpu.flagship import flagship_data

    cols = read_file_data(example_table_path)
    assert len(cols) == 9
    assert all(len(c) == 334 for c in cols)
    # The sweep starts at 2000 in the setpoint and field columns.
    assert cols[0][0] == pytest.approx(2000.0)
    assert cols[1][0] == pytest.approx(2000.0)
    # test.lisp's columns 1 (field) and 4 (signal) read back exactly.
    x, y = create_walker_data(cols, 1, 4)
    x0, y0 = flagship_data(0)
    np.testing.assert_array_equal(x, x0)
    np.testing.assert_array_equal(y, y0)


def test_read_file_handles_semicolon(tmp_path):
    # The NV loader uses ';' delimiters (nv-specific.lisp:10).
    p = tmp_path / "nv.csv"
    p.write_text("freq;a;b\n2850.0;1.0;2.0\n2851.0;1.5;2.5\n")
    cols = read_file_data(str(p))
    assert len(cols) == 3
    np.testing.assert_allclose(cols[0], [2850.0, 2851.0])


def test_read_file_pages(tmp_path):
    p = tmp_path / "pages.txt"
    p.write_text("1\t2\n3\t4\n\n5\t6\n7\t8\n")
    pages = read_file_data(str(p), pages=True)
    assert len(pages) == 2
    np.testing.assert_allclose(pages[1][0], [5.0, 7.0])


def test_lisp_style_exponents(tmp_path):
    p = tmp_path / "lisp.txt"
    p.write_text("1d-5\t2D+3\n")
    cols = read_file_data(str(p))
    assert cols[0][0] == pytest.approx(1e-5)
    assert cols[1][0] == pytest.approx(2e3)


def test_get_filename_include_exclude(tmp_path):
    (tmp_path / "example-data.xls").write_text("x")
    (tmp_path / "test-data.xls").write_text("x")
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "example-2.xls").write_text("x")
    # The test.lisp:10 pattern.
    found = get_filename(str(tmp_path), include=["example", ".xls"], exclude=["test"])
    names = [f.split("/")[-1] for f in found]
    assert names == ["example-data.xls", "example-2.xls"]


# -------------------------------------------------------------------- models
def test_registry_complete():
    for name in (
        "line",
        "example_line",
        "polynomial",
        "gaussian_peak",
        "lorentzian_bg",
        "lorder_mixed_bg",
        "double_lorentzian_bg",
        "exponential_decay",
        "sinusoid",
        "damped_sinusoid",
        "stretched_exponential",
        "power_law",
        "pseudo_voigt",
    ):
        assert name in MODEL_REGISTRY
        assert get_model(name) is MODEL_REGISTRY[name]


def test_example_line_matches_reference_formula():
    # example-function (mcmc-fitting.lisp:1178): b + -3m + (m - b/60) x
    import jax.numpy as jnp

    x = jnp.asarray([0.0, 1.0, 2.0])
    y = example_line(x, {"m": 2.0, "b": -1.0})
    expected = -1.0 + -6.0 + (2.0 + 1.0 / 60.0) * np.array([0.0, 1.0, 2.0])
    np.testing.assert_allclose(np.asarray(y), expected, rtol=1e-12)


def test_lorder_mixed_bg_shape():
    import jax.numpy as jnp

    x = jnp.linspace(2000.0, 3600.0, 334)
    p = {"scale": 1e-5, "linewidth": 100.0, "x0": 2780.0, "mix": 3.14,
         "bg0": 1e-7, "bg1": 1e-9}
    y = np.asarray(lorder_mixed_bg(x, p))
    assert np.isfinite(y).all()
    # Pure absorption derivative (mix=0) is antisymmetric about x0.
    p0 = dict(p, mix=0.0, bg0=0.0, bg1=0.0)
    xs = jnp.asarray([2780.0 - 50.0, 2780.0 + 50.0])
    ys = np.asarray(lorder_mixed_bg(xs, p0))
    assert ys[0] == pytest.approx(-ys[1], rel=1e-10)


def test_double_lorentzian_dips():
    import jax.numpy as jnp

    p = {"scale1": 1.0, "scale2": 1.0, "mu1": 2860.0, "mu2": 2875.0,
         "sigma": 5.0, "bg0": 10.0}
    x = jnp.asarray([2700.0, 2860.0, 2875.0])
    y = np.asarray(double_lorentzian_bg(x, p))
    assert y[0] == pytest.approx(10.0, abs=0.01)  # far from dips -> background
    assert y[1] < 9.2 and y[2] < 9.2              # dips go down


def test_polynomial_horner():
    import jax.numpy as jnp

    y = polynomial(jnp.asarray([2.0]), {"c0": 1.0, "c1": 2.0, "c2": 3.0})
    assert float(y[0]) == pytest.approx(1 + 4 + 12)


def test_gaussian_peak():
    import jax.numpy as jnp

    p = {"scale": 2.0, "x0": 1.0, "sigma": 0.5}
    assert float(gaussian_peak(jnp.asarray([1.0]), p)[0]) == pytest.approx(2.0)


def test_damped_sinusoid_envelope():
    import jax.numpy as jnp

    p = {"scale": 3.0, "tau": 2.0, "freq": 0.25, "phase": np.pi / 2, "bg0": 1.0}
    x = np.array([0.0, 2.0, 4.0])
    y = np.asarray(damped_sinusoid(jnp.asarray(x), p))
    expected = 3.0 * np.exp(-x / 2.0) * np.sin(2 * np.pi * 0.25 * x + np.pi / 2) + 1.0
    np.testing.assert_allclose(y, expected, rtol=1e-6)


def test_stretched_exponential_matches_and_handles_nonpositive():
    import jax.numpy as jnp

    p = {"scale": 2.0, "tau": 3.0, "beta": 0.7, "bg0": 0.5}
    x = np.array([0.5, 3.0, 9.0])
    y = np.asarray(stretched_exponential(jnp.asarray(x), p))
    np.testing.assert_allclose(
        y, 2.0 * np.exp(-((x / 3.0) ** 0.7)) + 0.5, rtol=1e-6)
    # x<=0 lanes (padding) take the x->0+ limit, never NaN
    y0 = np.asarray(stretched_exponential(jnp.asarray([-1.0, 0.0]), p))
    np.testing.assert_allclose(y0, [2.5, 2.5], rtol=1e-6)
    assert np.all(np.isfinite(y0))


def test_power_law_matches_and_handles_nonpositive():
    import jax.numpy as jnp

    p = {"scale": 2.0, "exponent": -1.5, "bg0": 0.25}
    x = np.array([1.0, 4.0])
    y = np.asarray(power_law(jnp.asarray(x), p))
    np.testing.assert_allclose(y, 2.0 * x ** -1.5 + 0.25, rtol=1e-6)
    y0 = np.asarray(power_law(jnp.asarray([0.0, -2.0]), p))
    np.testing.assert_allclose(y0, [0.25, 0.25], rtol=1e-6)


def test_pseudo_voigt_limits():
    import jax.numpy as jnp

    x = np.linspace(-2.0, 2.0, 41)
    base = {"scale": 5.0, "x0": 0.0, "w": 0.8}
    # eta=1 is the Lorentzian, eta=0 the Gaussian (ln2-scaled, so both
    # components share the same half-width at half-maximum).
    y_l = np.asarray(pseudo_voigt(jnp.asarray(x), {**base, "eta": 1.0}))
    y_g = np.asarray(pseudo_voigt(jnp.asarray(x), {**base, "eta": 0.0}))
    np.testing.assert_allclose(y_l, 5.0 * 0.8**2 / (x**2 + 0.8**2), rtol=1e-6)
    np.testing.assert_allclose(
        y_g, 5.0 * np.exp(-np.log(2.0) * x**2 / 0.8**2), rtol=1e-6)
    # both halve at |u| = w
    for y in (y_l, y_g):
        i = np.argmin(np.abs(x - 0.8))
        assert y[i] == pytest.approx(2.5, rel=1e-6)
    # intermediate eta interpolates
    y_h = np.asarray(pseudo_voigt(jnp.asarray(x), {**base, "eta": 0.4}))
    np.testing.assert_allclose(y_h, 0.4 * y_l + 0.6 * y_g, rtol=1e-6)


def test_pseudo_voigt_end_to_end_fit():
    """A small pseudo-Voigt fit recovers the generating parameters
    (bounds prior keeps eta in [0, 1])."""
    import jax.numpy as jnp

    import lisp_mcmc_tpu as mfit

    x = np.linspace(-5.0, 5.0, 120)
    truth = {"scale": 4.0, "x0": 0.6, "w": 1.1, "eta": 0.35, "bg0": 0.2}
    rng = np.random.default_rng(0)
    y = np.asarray(pseudo_voigt(jnp.asarray(x), truth)) + 0.02 * rng.standard_normal(x.size)
    w = mfit.walker_create(
        function=pseudo_voigt, data=(x, y),
        params={"scale": 3.0, "x0": 0.2, "w": 1.5, "eta": 0.5, "bg0": 0.1},
        data_error=0.02, n_walkers=256, seed=0, walker_jitter=0.1,
        log_prior=mfit.make_bounds_prior({"eta": (0.0, 1.0),
                                          "w": (0.05, 10.0),
                                          "scale": (0.0, 100.0)}),
    )
    w.adaptive_steps(4000, auto=None, temperature=2.0)
    best = w.most_likely_params()
    assert best["x0"] == pytest.approx(0.6, abs=0.05)
    assert best["w"] == pytest.approx(1.1, abs=0.15)
    assert best["eta"] == pytest.approx(0.35, abs=0.2)
    assert best["scale"] == pytest.approx(4.0, abs=0.4)


def test_ragged_row_drops_row_not_column(tmp_path):
    """One short row must not silently delete a whole column for the
    entire file (regression: min-width slicing)."""
    p = tmp_path / "ragged.txt"
    p.write_text("1\t2\t3\n4\t5\t6\n7\t8\n9\t10\t11\n")
    cols = read_file_data(str(p))
    assert len(cols) == 3
    np.testing.assert_allclose(cols[2], [3.0, 6.0, 11.0])
