"""The port's package root against the JAX package's: the same public
names (``__all__``), and ``list_benchmark_scenarios()`` naming the same
scenarios in the same order."""

import starway_tpu
import starway_tpu_torch


def test_root_names_match_jax():
    assert starway_tpu_torch.__all__ == starway_tpu.__all__
    for name in starway_tpu_torch.__all__:
        assert callable(getattr(starway_tpu_torch, name))


def test_list_benchmark_scenarios_matches_jax():
    got = starway_tpu_torch.list_benchmark_scenarios()
    assert got == starway_tpu.list_benchmark_scenarios()
    assert "reshard" in got and len(got) == len(set(got))
