"""chip_smoke.py: refuses to run off the card, and its phases run end to
end at tiny sizes on the CPU (the rehearsal of the card run)."""

from __future__ import annotations

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MiB = 1 << 20

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
)
cs = importlib.util.module_from_spec(_spec)
sys.modules.setdefault("chip_smoke", cs)
_spec.loader.exec_module(cs)


def _run(cwd) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=600,
    )


def test_exits_nonzero_on_cpu_backend():
    r = _run(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not 'gpu'" in r.stderr


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture
def ctx():
    return cs.Ctx(platform="cpu", card="(CPU rehearsal)", seed=1)


def test_gpt2_small_parameter_count():
    import jax

    shapes = cs.gpt2_shapes(**cs.GPT2_SMALL)
    leaves = jax.tree_util.tree_leaves(
        shapes, is_leaf=lambda s: isinstance(s, tuple)
    )
    count = 0
    for s in leaves:
        n = 1
        for d in s:
            n *= d
        count += n
    assert count == 124_439_808


def test_phase_device_arrays(ctx):
    cs.phase_device_arrays(ctx, nbytes=8 * MiB, zstd_bytes=8 * MiB)


def test_phase_checkpoint(ctx):
    cs.phase_checkpoint(
        ctx, {"n_layer": 2, "d_model": 64, "vocab": 500, "n_ctx": 32}
    )


def test_phase_strategies(ctx):
    cs.phase_strategies(ctx, nbytes=16 * MiB)


def test_phase_kernel_times(ctx):
    times = cs.phase_kernel_times(ctx, sizes=(4 * MiB,), reps=2)
    assert len(times) == 1 + 2 * 4 + 1
    assert all(t > 0 for t in times.values())


def test_phase_four_cards(ctx):
    cs.phase_four_cards(ctx, per_card=2 * MiB)


def test_a_failed_check_raises():
    with pytest.raises(cs.SmokeFailure, match="boom"):
        cs.check(False, "boom")
