"""The equivariant models at full depth and width (not ``reduced()``)
against the JAX package's, in one process on the CPU.

``chip_smoke.py`` trains NequIP (5 layers, 32 wide, l_max 2) and
Equiformer-v2 (12 layers, 128 wide, l_max 6, m_max 2) at their published
configurations on the molecule cell (128 molecules); the reduced parity
tests in ``test_torch_gnn_models.py`` cover 2 layers.  Here both packages
take three AdamW steps at the card's learning rate from the reference's
weights, on the first MOLECULES molecules of the same seeded batch (the
whole batch would hold some 45 GB of activations on the host for the two
packages' backward passes), and every step's loss must agree within 1e-4.
Run with ``-s`` to see the two trajectories."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GNN_SHAPES as R_GNN_SHAPES
from repro.configs.registry import get_config as r_get_config
from repro.models.gnn import api as r_api
from repro.optim import AdamW as RAdamW

from repro_torch import convert
from repro_torch.configs.base import GNN_SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.data.graphs import batch_to_device, random_graph_batch
from repro_torch.models.gnn import api
from repro_torch.optim import AdamW
from repro_torch.utils import tree

MOLECULES = 4
#: chip_smoke.py's GNN_LR_EQUIVARIANT
LR = 1e-4
CONVERT = {"nequip": convert.nequip_params_from_reference,
           "equiformer_v2": convert.equiformer_params_from_reference}


def _first_molecules(host, shape, g):
    """The first ``g`` molecules of a molecule-cell batch: their atoms,
    bonds and energies (the batch lays them out molecule by molecule)."""
    npg, epg = shape.dim("n_nodes"), shape.dim("n_edges")
    return {k: v[:g] if k == "targets" else v[:g * epg] if k.startswith("edge_")
            else v[:g * npg] for k, v in host.items()}


@pytest.mark.parametrize("arch", ["nequip", "equiformer-v2"])
def test_full_depth_train_steps_match_reference(arch):
    cfg, ref = get_config(arch), r_get_config(arch)
    shape = {s.name: s for s in GNN_SHAPES}["molecule"]
    r_shape = {s.name: s for s in R_GNN_SHAPES}["molecule"]
    host = _first_molecules(random_graph_batch(cfg, shape, seed=0), shape, MOLECULES)
    r_params = jax.jit(lambda k: r_api.init(k, ref, r_shape)[0])(jax.random.PRNGKey(0))
    params = CONVERT[cfg.kind](jax.tree.map(np.asarray, r_params), device="cpu")
    r_opt, opt = RAdamW(learning_rate=LR), AdamW(learning_rate=LR)
    r_state, state = r_opt.init(r_params), opt.init(params)
    r_step = jax.jit(r_api.make_train_step(ref, r_shape, r_opt))
    step = api.make_train_step(cfg, shape, opt)
    r_batch = {k: jnp.asarray(v) for k, v in host.items()}
    batch = batch_to_device(host, "cpu")
    r_losses, losses = [], []
    for _ in range(3):
        r_params, r_state, r_metrics = r_step(r_params, r_state, r_batch)
        params, state, metrics = step(params, state, batch)
        r_losses.append(float(r_metrics["loss"]))
        losses.append(float(metrics["loss"]))
    print(f"{cfg.name} ({cfg.n_layers} layers, {cfg.d_hidden} wide, l_max {cfg.l_max}) on "
          f"{MOLECULES} molecules, AdamW lr {LR}: losses reference {r_losses}, port {losses}")
    np.testing.assert_allclose(losses, r_losses, rtol=1e-4, atol=1e-6)
    assert all(bool(torch.isfinite(t).all()) for t in tree.leaves(params))
