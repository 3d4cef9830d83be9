"""The quant entry's bootstrap option (`quant -b B`) on the CPU at a tiny
size: a run is correct; replicates drawn from another seed, a replicate
left out, one altered and the float32 control are not; the reference's
seeds and its batched EM against their definitions; and without the
option the entry keeps and checks what it did before. Marked cuda, the
same at 1M pairs and B = 100 on the card."""

import json
import time

import numpy as np
import pytest

import tiny
from kbench import calibrate, harness
from reference import bootstrap
from reference.em import run_em

B = 8
LIMIT = 1e-9
SEED = 2**31 + 7


def _boot_cell(config=None, n_bootstrap=B):
    base = tiny.cell("bulk-pe100")
    wl = json.loads(json.dumps(base.wl))
    wl["options"] = {"bootstrap": n_bootstrap, "plaintext": False}
    wl["limits"]["bootstrap_gap"] = LIMIT
    return harness.Cell("bulk-pe100", base.manifest, wl=wl,
                        config=config or base.config)


def _run(cell, tmp_path, seed=SEED, device="cpu"):
    tmp = tmp_path / f"run{seed}"
    tmp.mkdir(parents=True)
    return harness.run_cell(cell, seed, 0.5, False, device, time.time(),
                            str(tmp))


def test_a_bootstrap_run_is_correct(tmp_path):
    out = _run(_boot_cell(), tmp_path)
    assert out["correct"], out["checks"]
    assert out["checks"]["bootstrap_gap"]["value"] <= LIMIT
    assert all(p["timings"]["bootstrap_s"] > 0 for p in out["per_sample"])


def _seed_plus_one(monkeypatch, cell):
    """The program draws its replicates from seed + 1."""
    from kallisto_tpu_torch.quant import pipeline

    run_bootstraps = pipeline.run_bootstraps

    def shifted(problem, counts, eff_lens, n_bootstrap, seed, **kw):
        return run_bootstraps(problem, counts, eff_lens, n_bootstrap,
                              seed + 1, **kw)

    monkeypatch.setattr(pipeline, "run_bootstraps", shifted)


def _one_altered(monkeypatch, cell):
    """Replicate 3's largest count is 1e-6 higher where it is made."""
    from kallisto_tpu_torch.quant import pipeline

    run_bootstraps = pipeline.run_bootstraps

    def altered(*args, **kw):
        got = np.array(run_bootstraps(*args, **kw))
        got[3, np.argmax(got[3])] *= 1 + 1e-6
        return got

    monkeypatch.setattr(pipeline, "run_bootstraps", altered)


def _one_left_out(monkeypatch, cell):
    """Replicate 3 left out of what the program hands back."""
    run = cell.entry.run

    def left_out(sample, out, index, device):
        frags, timings, kept = run(sample, out, index, device)
        kept["bootstraps"] = np.delete(kept["bootstraps"], 3, axis=0)
        return frags, timings, kept

    monkeypatch.setattr(cell.entry, "run", left_out)


@pytest.mark.parametrize("fault", (_seed_plus_one, _one_altered,
                                   _one_left_out),
                         ids=("seed_plus_one", "one_replicate_altered",
                              "one_replicate_left_out"))
def test_a_planted_fault_is_not_correct(fault, tmp_path, monkeypatch):
    cell = _boot_cell()
    fault(monkeypatch, cell)
    out = _run(cell, tmp_path)
    assert not out["correct"]
    checks = out["checks"]
    assert checks["bootstrap_gap"]["value"] > LIMIT, checks
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k != "bootstrap_gap"), checks


def test_the_float32_control_is_not_correct(tmp_path):
    """The control's replicates (the reference's EM in float32) fail
    bootstrap_gap; the program's pass on the same seeds."""
    cell = _boot_cell()
    got = []
    calibrate.readings(cell, [11], [11, 12], "cpu", str(tmp_path), got.append)
    gaps = {(r["kind"], r["seed"]): r["checks"]["bootstrap_gap"] for r in got}
    assert gaps[("program", 11)] <= LIMIT
    assert gaps[("em_float32", 11)] > LIMIT
    assert gaps[("em_float32", 12)] > LIMIT


@pytest.mark.cuda
def test_on_the_card_at_1m_pairs_and_100_replicates(card, tmp_path):
    """bulk-pe100's reads in samples of 1M pairs with `-b 100` through the
    harness on 3 seeds, each run correct, and the float32 control through
    calibration on 3 others, each over the limit; every reading is printed
    as a JSON line (pytest -s)."""
    full = harness.Cell("bulk-pe100", tiny.cell("bulk-pe100").manifest)
    cell = _boot_cell(dict(full.config, sample_size=1_000_000), 100)
    for seed in (2**31 + 211, 2**31 + 212, 2**31 + 213):
        out = _run(cell, tmp_path, seed, card)
        print(json.dumps({
            "seed": seed, "kind": "program", "correct": out["correct"],
            "checks": out["checks"], "sample_ends_s": out["sample_ends_s"],
            "memory_peak_bytes": out["device"]["memory_peak_bytes"],
            "timings": [{k: p["timings"].get(k) for k in (
                "run_s", "em_s", "bootstrap_s", "write_s")}
                for p in out["per_sample"]]}), flush=True)
        assert out["correct"], out["checks"]
    got = []
    calibrate.readings(cell, [], [2**31 + 221, 2**31 + 222, 2**31 + 223],
                       card, str(tmp_path), got.append)
    for r in got:
        print(json.dumps(r), flush=True)
    assert len(got) == 3
    assert all(r["checks"]["bootstrap_gap"] > LIMIT for r in got)


def test_mt19937_64_gives_the_standards_check_value():
    """The C++ standard's check: the 10,000th output of a default-seeded
    std::mt19937_64 (seed 5489)."""
    assert bootstrap.seeds(5489, 10000)[-1] == 9981545732273789042


def _classes(rng, T, n_classes):
    order = [(t,) for t in range(T)]
    while len(order) < n_classes:
        c = tuple(sorted(rng.choice(T, int(rng.integers(2, 5)),
                                    replace=False).tolist()))
        if c not in order:
            order.append(c)
    rng.shuffle(order)
    return order


def test_the_batched_em_equals_run_em_per_replicate():
    rng = np.random.default_rng(7)
    T = 30
    order = _classes(rng, T, 60)
    counts = rng.integers(0, 400, len(order)).astype(np.float64)
    counts[rng.random(len(order)) < 0.2] = 0
    drawn = np.stack([bootstrap.draw(counts, s)
                      for s in bootstrap.seeds(42, 6)])
    eff = rng.uniform(20.0, 2000.0, T)
    got = bootstrap.run_em_replicates(order, drawn, T, eff)
    want = np.stack([run_em(dict(zip(order, row)), T, eff) for row in drawn])
    np.testing.assert_array_equal(got, want)


def test_the_draws_follow_the_class_order():
    """The same counts listed in another order give other draws, each
    replicate with the sample's n; an order asked twice is solved once."""
    rng = np.random.default_rng(3)
    T = 20
    order = _classes(rng, T, 40)
    classes = {c: int(rng.integers(1, 300)) for c in order}
    reps = bootstrap.Replicates(classes, T, np.full(T, 150.0), 4, 42,
                                np.zeros(T))
    a = reps.for_order(order)
    assert reps.for_order(list(order)) is a
    b = reps.for_order(order[::-1])
    assert a.shape == b.shape == (4, T)
    assert not np.array_equal(a, b)
    n = sum(classes.values())
    np.testing.assert_allclose(a.sum(1), n, rtol=1e-9)
    np.testing.assert_allclose(b.sum(1), n, rtol=1e-9)


def test_without_bootstrap_the_entry_keeps_and_checks_as_before(
        tmp_path, monkeypatch):
    cell = tiny.cell("bulk-pe100")
    assert "bootstrap" not in cell.wl.get("options", {})
    run, kept_keys = cell.entry.run, []

    def keep(sample, out, index, device):
        got = run(sample, out, index, device)
        kept_keys.append(set(got[2]))
        return got

    monkeypatch.setattr(cell.entry, "run", keep)
    out = _run(cell, tmp_path)
    assert out["correct"], out["checks"]
    assert kept_keys and all(k == {"n", "counts", "ec_sets", "flens",
                                   "est_counts"} for k in kept_keys)
    assert set(out["checks"]) == {"processed_gap", "class_count_gap",
                                  "fld_gap", "est_counts_gap"}
