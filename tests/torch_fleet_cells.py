"""Shared pieces of the replica-fleet parity tests
(``tests/test_torch_{lifecycle,replicas,gateway}.py``): ``llama_tiny``
weights from a seed, and the same fleet built by both packages (the JAX
package's replicas on its virtual CPU devices, the port's all on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np

from dlti_tpu.config import MODEL_PRESETS as JAX_PRESETS
from dlti_tpu.config import ReplicaLifecycleConfig as JaxLifecycleConfig
from dlti_tpu.models import LlamaForCausalLM as JaxLlama
from dlti_tpu.serving import EngineConfig as JaxEngineConfig
from dlti_tpu.serving import ReplicatedEngine as JaxReplicated
from dlti_tpu.serving import SamplingParams as JaxSamplingParams
from dlti_tpu_torch.config import MODEL_PRESETS, ReplicaLifecycleConfig
from dlti_tpu_torch.models import params_from_jax
from dlti_tpu_torch.serving import EngineConfig, ReplicatedEngine, SamplingParams

PROMPTS = [[1, 2, 3, 4, 5], [6, 7, 8], [9, 10, 11, 12], [13, 14]]
EC = dict(max_seqs=4, block_size=8, num_blocks=64, max_model_len=128, eos_token_id=-1)


def seeded_params():
    """JAX init plus numpy noise (no float32 near-tie decides a greedy
    token), as host numpy leaves."""
    cfg = JAX_PRESETS["llama_tiny"]
    tree = JaxLlama(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32),
        jax.device_get(tree))


def fleets(params, replicas=2, heal=False, cache_dtype="float32", steps_per_sync=1,
           **kw):
    """(JAX fleet, port fleet) on the same weights and configuration."""
    ec = dict(EC, cache_dtype=cache_dtype, steps_per_sync=steps_per_sync)
    lc = dict(enabled=heal, probation_initial_s=0.0)
    jrep = JaxReplicated(JAX_PRESETS["llama_tiny"], jax.tree_util.tree_map(jnp.asarray, params),
                         JaxEngineConfig(**ec), replicas=replicas, tensor=1,
                         devices=jax.devices()[:replicas],
                         lifecycle_cfg=JaxLifecycleConfig(**lc), **kw)
    trep = ReplicatedEngine(MODEL_PRESETS["llama_tiny"], params_from_jax(params),
                            EngineConfig(**ec), replicas=replicas, device="cpu",
                            lifecycle_cfg=ReplicaLifecycleConfig(**lc), **kw)
    return jrep, trep


def greedy(n, package="torch"):
    return (SamplingParams if package == "torch" else JaxSamplingParams)(
        temperature=0.0, max_tokens=n)


def run(rep, reqs, max_steps=2000):
    """Step a fleet until it has no work (and no reload rolls); returns
    ``reqs``."""
    for _ in range(max_steps):
        if not rep.has_work and rep._reload is None:
            break
        rep.step()
    assert not rep.has_work and rep._reload is None, "the fleet did not drain"
    return reqs


def outcome(reqs):
    """What the parity tests hold equal: tokens, finish reasons, retries,
    migrations and the replica each request ended on."""
    return [(list(r.output_token_ids), r.finish_reason, r.num_retries, r.num_migrations,
             r.replica) for r in reqs]
