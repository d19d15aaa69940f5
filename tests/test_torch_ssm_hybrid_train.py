"""zamba2-smoke (the hybrid: Mamba2 layers and one shared attention
block) training under ``zero_one_adam`` against the reference live: the
8-step trainers in single mode and with 2 and 4 simulated workers, under
the bars and learning rate of ``tests/test_torch_ssm_train.py``, whose
check this file runs (its ``adam`` trainers and its reshard:
``tests/test_torch_ssm_hybrid.py``; the cases sit in several files so
that each file stays near 90 s).
"""
import pytest
import torch

from test_torch_ssm_train import check_trainer_against_reference

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_zamba2_trainer_matches_reference(n):
    check_trainer_against_reference("zamba2-1.2b", n, "zero_one_adam")
