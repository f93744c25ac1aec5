"""The port's mesh through its entry points, on the CPU with gloo
ranks (one thread each; rendezvous through a file under ``tmp_path``):
4 ranks of (data=2, pixel=2) NTC gather steps against one rank, the
decode CLI's ``--devices 2`` rank program on 2 ranks against one device
bit for bit, and ``nic_torch.parallel.dryrun.dryrun_multichip(2,
device="cpu")``. The checks against
JAX's mesh are in ``tests/test_torch_parallel.py``.
"""

import os

import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from nic_torch.parallel.mesh import run_ranks
from torch_parallel_ranks import check_steps


def test_data_by_pixel_mesh_gather_step(tmp_path):
    """A (data=2, pixel=2) mesh of 4 ranks: crops over 'data', each crop's
    pixels over 'pixel' (the gather engine), from the trainers' own
    identically seeded streams; against the port's one-rank run."""
    four = run_ranks(ranks.ntc_train_steps, 4, data_axis=2, device="cpu",
                     workdir=str(tmp_path), threads=1)
    assert len({r["digest"] for r in four}) == 1
    one = ranks.ntc_train_steps(None)
    check_steps(four[0], one["losses"], one["grads"], one["params"], 1e-6,
                 "2x2 vs one rank")


def test_decode_cli_ranks_match_one_device(tmp_path):
    """The rank program ``decode --devices 2`` spawns (the cuda backend's
    routing with the sharded entry) on 2 CPU ranks, where K1 runs its
    plain version, equal bit for bit to the same routing on one device;
    the command itself refuses ``--devices 2`` without a card's kernel to
    split."""
    from nic_torch.cli import decode as dcli

    art = os.path.join(os.path.dirname(__file__), "fixtures",
                       "ntc_sancho512_fp8.npz")
    args = dcli._parser().parse_args([art, "--device", "cpu", "--backend",
                                      "cuda", "--mip", "1"])
    two = run_ranks(dcli._rank_decode, 2, args, device="cpu",
                    workdir=str(tmp_path), threads=1)
    rec, _, backend, ndim = two[0]
    assert two[1][0] is None  # rank 0 alone returns the image
    one = dcli._decode(args, torch.device("cpu"))
    assert (backend, ndim) == one[2:] == ("cuda", 2)
    assert rec.shape == (256, 256, 3)
    np.testing.assert_array_equal(rec, one[0])
    with pytest.raises(SystemExit):
        dcli.run([art, "--device", "cpu", "--devices", "2"])


def test_dryrun_multichip_two_ranks():
    from nic_torch.parallel.dryrun import dryrun_multichip

    if not torch.cuda.is_available():  # the card by default, no fallback
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun_multichip(2)
    got = dryrun_multichip(2, device="cpu")
    assert got["ntc kernel3"][1] == "kernel3_sharded"
    assert got["decode"] == ((64, 64, 3), True)
