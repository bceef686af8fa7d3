"""Model families on the multi-level arrow SpMM (port of
``arrow_matrix_tpu/models``): SGC, GCN and APPNP with their carried
(fold) forms, trained with ``torch.optim`` through the executor's
differentiable step, and the solvers PageRank, label propagation, power
iteration and conjugate gradient."""

from arrow_matrix_tpu_torch.models.propagation import (
    APPNPCarried,
    APPNPModel,
    GCNCarried,
    GCNModel,
    SGCCarried,
    SGCModel,
    SGCParams,
    appnp_forward,
    conjugate_gradient,
    gcn_forward,
    gcn_init,
    label_propagation,
    label_propagation_carried,
    make_appnp_train_step,
    make_gcn_train_step,
    make_train_step,
    pagerank,
    pagerank_carried,
    power_iteration,
    sgc_forward,
    sgc_init,
)

__all__ = [
    "APPNPCarried",
    "APPNPModel",
    "GCNCarried",
    "GCNModel",
    "SGCCarried",
    "SGCModel",
    "SGCParams",
    "appnp_forward",
    "conjugate_gradient",
    "gcn_forward",
    "gcn_init",
    "label_propagation",
    "label_propagation_carried",
    "make_appnp_train_step",
    "make_gcn_train_step",
    "make_train_step",
    "pagerank",
    "pagerank_carried",
    "power_iteration",
    "sgc_forward",
    "sgc_init",
]
