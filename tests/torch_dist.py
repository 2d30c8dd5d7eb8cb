"""Runs tests/_torch_dist_worker.py as a data-parallel group of processes
on the CPU (gloo through a FileStore under the test's tmp_path), each with
its own time limit, and reads back what each process wrote."""
import os
import pickle
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
TIMEOUT_S = 120


def start(tmp_path, case, world=2, name="run"):
    """Start ``world`` workers on ``case`` -> (processes, their out paths,
    their log paths)."""
    d = tmp_path / name
    d.mkdir()
    with open(d / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs, outs, logs = [], [], []
    for r in range(world):
        outs.append(d / ("out%d.pkl" % r))
        logs.append(d / ("log%d.txt" % r))
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(d / "case.pkl"), str(r),
                 str(world), str(d / "store"), str(outs[-1])],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
    return procs, outs, logs


def wait(procs, logs, timeout=TIMEOUT_S):
    """Wait for every process (at most ``timeout`` s each; then all are
    killed) -> their return codes."""
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=timeout))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError("a worker hung:\n" + "\n".join(
            open(lg).read()[-3000:] for lg in logs))
    return rcs


def run(tmp_path, case, world=2, name="run", timeout=TIMEOUT_S):
    """Run the group to its end; every process must exit 0.  -> the list
    of what each process wrote, in rank order."""
    procs, outs, logs = start(tmp_path, case, world, name)
    rcs = wait(procs, logs, timeout)
    assert rcs == [0] * world, "workers exited %s:\n%s" % (rcs, "\n".join(
        open(lg).read()[-4000:] for lg in logs))
    out = []
    for path in outs:
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out
