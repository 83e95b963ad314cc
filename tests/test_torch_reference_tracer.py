"""The port's parity tests leave the JAX package's tracer as they found it.

``repro.obs.trace.tracing()`` clears the process-wide tracer's events on
entry and restores only its flags on exit, so a test that drives it (or
``registry.explain``, which records through it) would leave events behind
for the next test in the same process, and
``tests/test_obs.py::test_tracing_disabled_by_default_and_noop`` expects
none.  The port's tests that drive the reference's tracer use
``_torch_parity.jax_tracer_kept``; this runs them and then that test in
one process, in that order, without xdist.
"""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: the port's tests that drive the JAX package's tracer, then the
#: reference test that expects an empty tracer
ORDER = [
    "tests/test_torch_runtime.py::test_replan_mode_traces_its_decision",
    "tests/test_torch_registry.py::test_explain_matches_the_reference"
    "[rect-nicol]",
    "tests/test_torch_registry.py::test_explain_matches_the_reference"
    "[sgorp-2d]",
    "tests/test_torch_registry.py::test_explain_nests_in_an_outer_recording",
    "tests/test_obs.py::test_tracing_disabled_by_default_and_noop",
]


def test_reference_tracer_is_left_empty():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist", "-p",
         "no:randomly", "-p", "no:cacheprovider", *ORDER],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-2000:]
    assert f"{len(ORDER)} passed" in r.stdout, r.stdout[-3000:]
