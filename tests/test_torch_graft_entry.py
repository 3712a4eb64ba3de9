"""The port's graft entry points (``clair3_tpu_torch/graft_entry.py``)
against ``__graft_entry__.py``, on the CPU:

* the twin of ``tests/test_train_step.py::test_graft_entry_contract``:
  ``entry(device="cpu")`` gives ``[256, 90]`` probabilities on the JAX
  entry's input, equal to the JAX ``entry()``'s ``fn`` on the port net's
  weights carried across by the bridge, within 1e-4 (the FA net's f32
  bound; the two conv libraries sum in other orders);
* ``dryrun_multichip(8)``, eight gloo ranks each an OS process for the
  training step, prints its ok line (its training loss finite, the engine
  batch ``(16, 90)``) after the engine batch ran over eight CPU replicas.
"""

import os
import re
import subprocess
import sys

import numpy as np

import __graft_entry__ as jax_entry
from clair3_tpu_torch.graft_entry import entry
from clair3_tpu_torch.models.bridge import to_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_matches_the_jax_entry():
    fn, (model, x) = entry(device="cpu")
    got = fn(model, x)
    assert got.shape == (256, 90)
    jfn, (_, jx) = jax_entry.entry()
    assert np.array_equal(x.numpy(), np.asarray(jx))
    want = np.asarray(jfn(to_jax_variables(model.state_dict()), jx))
    err = np.abs(got.numpy() - want).max()
    print(f"[port-entry] max |dp| {err:.3g}")
    assert err <= 1e-4


def test_dryrun_multichip_8_ranks():
    proc = subprocess.run(
        [sys.executable, "-c",
         "from clair3_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(8)"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert re.search(r"^\[dryrun_multichip\] engine batch of 16 rows over 8 devices \(cpu\), "
                     r"2 rows each$", proc.stdout, re.M), proc.stdout[-3000:]
    m = re.search(r"^\[dryrun_multichip\] n_devices=8 loss=(\S+) infer=\(16, 90\) "
                  r"cascade_rows=(\d+) ok$", proc.stdout, re.M)
    assert m, proc.stdout[-3000:]
    assert np.isfinite(float(m.group(1))) and int(m.group(2)) > 0
