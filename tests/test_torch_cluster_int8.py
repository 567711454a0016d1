"""The port's disaggregated cluster over int8 pools against the JAX
package's: the parity matrix of ``tests/test_torch_cluster.py``
(``attention_pool`` × ``head | request | block``, prefix sharing, chunks
of 8, 2 blocks a step, two affinity-routed replicas) with
``kv_dtype="int8"``: the payloads carry the scale tiles, and greedy
outputs, summaries, event kinds and routes equal the JAX cluster's."""
import pytest

from test_torch_cluster import held_to_jax_cluster
from test_torch_cluster import llama  # noqa: F401  (the fixture)
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("partition", ["head", "request", "block"])
def test_int8_cluster_matches_jax_cluster_and_single_engine(
        llama, partition):  # noqa: F811
    held_to_jax_cluster(llama, partition, "int8")
