"""The cascade driver and its reference on the CPU at a tiny size in fp32:
the program agrees with the reference, the control (the reference in float8
in the program's place) does not, and a run whose timed path is broken
underneath comes out not correct."""

import pytest
import torch

import prpe_tpu_torch.infer.cascade as program_cascade
from benchmark import control, harness
from benchmark.reference.judge import NUMBERS

CPU = torch.device("cpu")


def _run(root, seed=2**31 + 11):
    return harness.run("tiny.cascade", seed, 0.3, False, root=root, device=CPU,
                       dtype=torch.float32)


def test_program_matches_reference(shared_root):
    out = _run(shared_root)
    assert out["correct"], out["check"]
    assert set(out["check"]) == set(NUMBERS)


def test_the_check_is_not_vacuous(shared_root):
    """The tiny cell's answers carry detections, face slots and, on this
    seed, gated persons with pose slots, so every stage is judged."""
    _, _, traffic, cfg = harness.load_cell(shared_root, "tiny.cascade")
    mod = harness.load_module(shared_root / "benchmark" / "drivers" / "cascade.py", "drv_t")
    d = mod.Driver(cfg, traffic, 2**31 + 11, CPU, torch.float32, harness.log)
    d.setup()
    for i in range(4):
        d.call(i)
    a = [c["answers"] for c in d.calls]
    assert all(x["person_valid"].any() and x["face_valid"].any() for x in a)
    assert any(x["pose_valid"].any() for x in a)
    assert any((x["face_similarity"] > -1).any() for x in a)


def _broken(monkeypatch, fault):
    real = program_cascade.build_cascade_runner

    def build(*args, **kwargs):
        run = real(*args, **kwargs)
        return lambda images, gallery: fault(run, images, gallery)
    monkeypatch.setattr(program_cascade, "build_cascade_runner", build)


def _half_batch(run, images, gallery):
    """Half of the batch left out: the first half's answers stand for all."""
    h = images.shape[0] // 2
    return run(torch.cat([images[:h], images[:h]]), gallery)


def _altered(run, images, gallery):
    """One answer altered where it is produced: a person's gate flipped."""
    res = run(images, gallery)
    gated = res.person_gated.clone()
    gated[0, 0] = ~gated[0, 0]
    return res._replace(person_gated=gated)


@pytest.mark.parametrize("fault", [_half_batch, _altered], ids=["half_batch", "altered_answer"])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    """Each fault fails, among others, the comparison with the reference's
    own whole cascade, which follows none of the program's decisions."""
    _broken(monkeypatch, fault)
    out = _run(tiny_root)
    assert not out["correct"], out["check"]
    assert out["check"]["e2e_miss"]["value"] > out["check"]["e2e_miss"]["limit"]


def test_control_fails_where_the_program_passes(shared_root):
    prog = control.readings("tiny.cascade", [2**31 + 11], "program", root=shared_root,
                            device=CPU, dtype=torch.float32)[0]
    ctrl = control.readings("tiny.cascade", [2**31 + 11], "control", root=shared_root,
                            device=CPU, dtype=torch.float32)[0]
    _, _, traffic, _ = harness.load_cell(shared_root, "tiny.cascade")
    limits = traffic["limits"]
    assert all(prog[k] <= limits[k] for k in limits)
    assert any(ctrl[k] > limits[k] for k in limits)
    assert ctrl["det_err"] > 10 * max(prog["det_err"], 1e-6)
    assert prog["structure"] == ctrl["structure"] == 0


@pytest.mark.cuda
def test_control_on_the_card():
    """The control at the cell's own size on the card (``-m cuda``): it has
    to fail the cell's limits on every seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, _, traffic, _ = harness.load_cell(harness.ROOT, "cascade.b128")
    for r in control.readings("cascade.b128", [7, 8, 9], "control"):
        assert any(r[k] > v for k, v in traffic["limits"].items()), r
