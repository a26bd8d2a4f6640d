#!/usr/bin/env python3
"""512^3 multihost + kill-and-resume demonstration.

Runs, as far as this single-host environment allows, the north-star
multi-device configuration:

  1. ``mh``:   512^3 mixed-precision sharded solve over 2 processes x 4
               virtual CPU devices each (z across processes, y across
               the devices of a process), a few cycles, with the
               replicated checksum compared against a single-process
               solve of the identical problem.
  2. ``kill``: 512^3 mixed GSPMD solve over an 8-virtual-device mesh run
               under ``solve_checkpointed`` in a child process that is
               SIGKILLed mid-run after its first checkpoint lands, then
               resumed to completion; the resumed iterate must match an
               uninterrupted run BITWISE (the iterate-sequence
               invariance contract of solve_checkpointed).

Usage: python3 scripts/multihost_512.py [mh|kill|all] [--n N]
(CPU-only: it forces JAX_PLATFORMS=cpu in every process it starts.)
"""

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _cpu_env(ndev=None):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    if ndev:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ndev}"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def run_mh(n: int, nproc: int = 2, ndev: int = 4, cycles: int = 2,
           ckpt: str | None = None) -> None:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env_common = _cpu_env()
    env_common.update(
        {
            "NDSM_MH_COORD": f"127.0.0.1:{port}",
            "NDSM_MH_NPROC": str(nproc),
            "NDSM_MH_NDEV": str(ndev),
            "NDSM_MH_SIZE": f"{n},{n},{n}",
            "NDSM_MH_NGRIDS": "0",  # reference depth rule
            "NDSM_MH_CYCLES": str(cycles),
        }
    )
    if ckpt:
        env_common["NDSM_MH_CKPT"] = ckpt
    t0 = time.time()
    procs = []
    for pid in range(nproc):
        env = dict(env_common)
        env["NDSM_MH_PID"] = str(pid)
        procs.append(
            subprocess.Popen(
                [sys.executable, "-m", "ndsm_tpu.parallel._mh_worker"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
        )
    outs = [p.communicate(timeout=5400) for p in procs]
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"worker rc={p.returncode}:\n{se[-3000:]}"
            )
    line = next(
        ln for so, _ in outs for ln in so.splitlines()
        if ln.startswith("MH_CHECKSUM")
    )
    _, chks, cyc = line.split()
    t_mh = time.time() - t0
    print(
        f"multihost {nproc}x{ndev} at {n}^3 mixed: cycles={cyc}, "
        f"checksum={chks}, wall={t_mh:.1f}s", flush=True,
    )

    # single-process reference of the identical problem
    import numpy as np

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    from ndsm_tpu import GridHierarchy, Options
    from ndsm_tpu.mg.poisson import PoissonBVP
    from ndsm_tpu.utils.msgs import suppress_warnings

    x = np.linspace(0.0, 1.0, n)
    h = GridHierarchy.from_mesh((x, x, x))
    bvp = PoissonBVP(
        h,
        (("D", "D"), ("N", "N"), ("D", "D")),
        Options(
            precision="mixed", ncycles_max=int(cycles), vc_tol=1e-30,
            niterex_max=40, mixed_inner_max=1,
        ),
    )
    rng = np.random.default_rng(7)
    t0 = time.time()
    with suppress_warnings():
        u_ref, info_ref = bvp.solve(
            np.zeros((n, n, n)), rng.standard_normal((n, n, n))
        )
    import jax.numpy as jnp

    s_ref = float(jnp.sum(jnp.abs(u_ref)))
    rel = abs(float(chks) - s_ref) / max(abs(s_ref), 1e-30)
    print(
        f"single-process reference: cycles={info_ref.cycles}, "
        f"checksum={s_ref:.12e}, wall={time.time() - t0:.1f}s", flush=True,
    )
    assert int(cyc) == info_ref.cycles, (cyc, info_ref.cycles)
    assert rel < 1e-8, (chks, s_ref, rel)
    print(f"MH_512_OK rel={rel:.2e}")


_CKPT_CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["NDSM_REPO"])
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from ndsm_tpu import GridHierarchy, Options
from ndsm_tpu.mg.poisson import PoissonBVP
from ndsm_tpu.parallel.shard import ShardSpec, make_mesh
from ndsm_tpu.utils.msgs import suppress_warnings

n = int(os.environ["NDSM_CK_N"])
path = os.environ["NDSM_CK_PATH"]
x = np.linspace(0.0, 1.0, n)
h = GridHierarchy.from_mesh((x, x, x))
spec = ShardSpec(mesh=make_mesh(8), min_rows_per_shard=2)
bvp = PoissonBVP(
    h,
    (("D", "D"), ("N", "N"), ("D", "D")),
    Options(precision="mixed", vc_tol=1e-30, niterex_max=40),
    shard_spec=spec,
)
rng = np.random.default_rng(11)
rhs = rng.standard_normal((n, n, n))
with suppress_warnings():
    u, info = bvp.solve_checkpointed(
        np.zeros((n, n, n)), rhs,
        checkpoint_path=path, checkpoint_every=1,
        ncycles_max=int(os.environ.get("NDSM_CK_CYCLES", "3")),
    )
np.save(path + ".final.npy", np.asarray(u))
print("CKPT_DONE", info.cycles, flush=True)
"""


def run_kill(n: int, cycles: int = 3) -> None:
    import numpy as np

    path = f"/tmp/ndsm_ck_{n}.npz"
    for p in (path, path + ".final.npy"):
        if os.path.exists(p):
            os.remove(p)
    env = _cpu_env(ndev=8)
    env["NDSM_REPO"] = REPO
    env["NDSM_CK_N"] = str(n)
    env["NDSM_CK_PATH"] = path
    env["NDSM_CK_CYCLES"] = str(cycles)

    # Phase 1: launch, SIGKILL after the first checkpoint lands.
    t0 = time.time()
    child = subprocess.Popen(
        [sys.executable, "-c", _CKPT_CHILD], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    killed = False
    while child.poll() is None:
        if os.path.exists(path):
            time.sleep(0.2)  # let the atomic rename settle + run a bit
            child.send_signal(signal.SIGKILL)
            killed = True
            break
        time.sleep(0.5)
    child.wait()
    if not killed:
        raise RuntimeError(
            "child finished before the first checkpoint could be killed:\n"
            + (child.stdout.read() or "")[-2000:]
        )
    ck = np.load(path)
    print(
        f"killed mid-run after checkpoint at cycle {int(ck['cycles'])} "
        f"({time.time() - t0:.1f}s)", flush=True,
    )

    # Phase 2: resume to completion from the checkpoint.
    child2 = subprocess.run(
        [sys.executable, "-c", _CKPT_CHILD], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=5400,
    )
    if child2.returncode != 0 or "CKPT_DONE" not in child2.stdout:
        raise RuntimeError(f"resume failed:\n{child2.stdout[-3000:]}")
    u_resumed = np.load(path + ".final.npy")

    # Phase 3: uninterrupted run, fresh checkpoint path.
    for p in (path, path + ".final.npy"):
        os.remove(p)
    child3 = subprocess.run(
        [sys.executable, "-c", _CKPT_CHILD], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=5400,
    )
    if child3.returncode != 0:
        raise RuntimeError(f"uninterrupted run failed:\n{child3.stdout[-3000:]}")
    u_full = np.load(path + ".final.npy")
    bitwise = np.array_equal(u_resumed, u_full)
    print(f"resume-vs-uninterrupted bitwise: {bitwise}")
    assert bitwise
    print("KILL_RESUME_OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("stage", nargs="?", default="all",
                    choices=["mh", "kill", "all", "mh-ck"])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--cycles", type=int, default=2)
    args = ap.parse_args()
    if args.stage in ("mh", "all"):
        run_mh(args.n, cycles=args.cycles)
    if args.stage == "mh-ck":
        # multihost solve_checkpointed: same checksum contract, plus a
        # resume pass that must do 0 further cycles
        import tempfile

        ck = os.path.join(tempfile.mkdtemp(), "mhck.npz")
        run_mh(args.n, cycles=args.cycles, ckpt=ck)
        print("mh-ck: checkpointed multihost run matched; resume check...")
        run_mh(args.n, cycles=args.cycles, ckpt=ck)
        print("MH_CK_OK")
    if args.stage in ("kill", "all"):
        run_kill(args.n, cycles=max(3, args.cycles + 1))
