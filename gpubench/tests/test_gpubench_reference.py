"""The reference agrees with the program's CPU path at a tiny size, and its
pieces agree with plain definitions."""
import json
import os

import numpy as np
import pytest

from conftest import REPO, TINY_DATA, tiny_config
from gpubench.check import Reference
from gpubench.data import make_dataset
from gpubench.harness import run_cell
from gpubench.inputs import tn5_pwm, vplot_template
from gpubench.reference import chain


def _reference(cfg: dict, seed: int = 3):
    data = make_dataset(cfg["data"], seed)
    v = cfg["run_config"]["vmat"]
    probs, up = tn5_pwm()
    tm = vplot_template(v["lower"], v["upper"], v["width"], v["smooth_sd_size"],
                        v["smooth_sd_pos"])
    return data, Reference(cfg["run_config"], data, tm, probs, up)


def test_inputs_are_the_programs_stated_defaults():
    """The template and PWM the benchmark hands out are the synthetic
    defaults the configuration states (the program's VMat.default and
    PWM.default)."""
    from nucleoatac_torch.core.pwm import PWM
    from nucleoatac_torch.core.vmat import VMat

    np.testing.assert_allclose(vplot_template(105, 251, 147, 1.0, 1.0), VMat.default().mat,
                               rtol=1e-12, atol=1e-18)
    probs, up = tn5_pwm()
    np.testing.assert_array_equal(probs, PWM.default().probs)
    assert up == PWM.default().up


def test_tiles_histogram_and_mixture_match_the_program():
    from gpubench.port import Port

    cfg = tiny_config("tiny", 1, 4)
    data, ref = _reference(cfg)
    port = Port(cfg["run_config"], data, 1, "cpu")
    assert set(ref.tiles) == {(t.chrom, t.core_start, t.core_end, t.win_start)
                              for t in port.tiles}
    assert ref.width == port.engine.width
    occ = port.cfg.occ
    np.testing.assert_allclose(ref.log_mix, port.mix.log_mix_table(occ), rtol=1e-13)
    np.testing.assert_allclose(ref.q, port.engine.size_probs64, rtol=1e-13)
    for c in data.names:
        np.testing.assert_array_equal(ref.frags[c][0], port.frags.mids[c])
        np.testing.assert_array_equal(ref.frags[c][1], port.frags.sizes[c])


@pytest.mark.parametrize("workload", ["tiny.fused", "tiny.twopass", "tiny2.fused"])
def test_program_cpu_path_within_the_limits(tiny_root, workload):
    line = run_cell(tiny_root, workload, 2**31 + 11, 3.0, False, device_type="cpu")
    assert line["correct"], line["checks"]
    c = {k: v["value"] for k, v in line["checks"].items()}
    assert c["occ_cert_mismatch"] == 0 and c["tile_mismatch"] == 0
    assert c["nuc_norm_steps"] < 0.6
    assert line["sampled"]["windows"] > 0
    assert list(line)[-1] == "checks"


def test_corr_rows_is_the_sum_of_row_correlations():
    rng = np.random.default_rng(0)
    mat, kern = rng.normal(size=(7, 50)), rng.normal(size=(7, 9))
    want = sum(np.correlate(mat[s], kern[s], mode="valid") for s in range(7))
    np.testing.assert_allclose(chain.corr_rows(mat, kern), want, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(chain.corr_1d(mat[0], kern[0]),
                               np.correlate(mat[0], kern[0], mode="valid"), rtol=1e-12)


def test_mirror_formulas_of_occupancy_and_scores():
    """The reference's occupancy and norm agree with the program's float64
    mirror (its frozen formulas) on one window."""
    from nucleoatac_torch import mirror

    cfg = tiny_config("tiny", 1, 4)
    data, ref = _reference(cfg)
    chrom, _, _, ws = ref.tiles[1]
    mat = ref.raster(chrom, ws)
    p = ref.occ(chrom, ws)
    m = mirror.occupancy_window(mat, ref.log_mix, np.linspace(0, 1, 101), ref.flank,
                                ref.ci_drop)
    grid = np.linspace(0, 1, 101)
    core = slice(ref.halo, ref.halo + ref.core)
    occ = np.where(p.empty, 0.0, grid[p.best])
    np.testing.assert_array_equal(occ, m.occ[core])
    lb = chain.log_bias(data.genome[chrom], data.lengths[0], ws, ref.width, ref.up,
                        ref.log_ratio)
    b0 = chain.bias_matrix(lb, ref.q, ref.vlo, ref.vhi, ref.halo, ref.width - ref.halo)
    b0m = mirror.bias_mat(lb, ref.q, ref.vlo, ref.vhi, ref.halo, ref.width - ref.halo)
    np.testing.assert_allclose(b0, b0m, rtol=1e-13)
    F = mat[ref.vlo - ref.lower:ref.vhi - ref.lower]
    want = mirror.nuc_scores(F, b0m, ref.template, 1e-5, ref.var_floor).norm
    got = chain.nuc_norm(F, b0, ref.template, ref.var_floor)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.14159], np.float32)
    got = chain.tf32(x)
    np.testing.assert_array_equal(got[:4], [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9])
    assert abs(got[4] + 3.14159) < 2**-10 * 4


def test_u16_roundtrip_error_is_half_a_step():
    rng = np.random.default_rng(1)
    x = rng.normal(size=1000).astype(np.float32) * 7
    dec, step = chain.u16_roundtrip(x)
    ulp = float(np.spacing(np.abs(x).max()))  # the float32 decode rounds too
    assert step > 0 and np.abs(dec - x).max() <= 0.5 * step + 4 * ulp


def test_generator_repeatable_by_seed():
    spec = dict(json.load(open(os.path.join(REPO, "gpubench", "configs",
                                            "chrom-1card.json")))["data"], **TINY_DATA)
    a, b, c = (make_dataset(spec, s) for s in (2**31 + 3, 2**31 + 3, 2**31 + 4))
    for ch in a.names:
        np.testing.assert_array_equal(a.lefts[ch], b.lefts[ch])
        np.testing.assert_array_equal(a.tlens[ch], b.tlens[ch])
        np.testing.assert_array_equal(a.genome[ch], b.genome[ch])
        assert not np.array_equal(a.lefts[ch], c.lefts[ch])
        assert len(a.lefts[ch]) == len(c.lefts[ch])  # every seed the same counts
    assert a.peaks == c.peaks and a.lengths == c.lengths
    assert a.n_fragments() == 2 * 3 * 400
