"""Control plane: how the channel spends its resources, hop by hop.

Counterpart of ``repro/control/``: :mod:`repro_torch.control.adaptive`
(the adaptive codec controllers, per hop and per serve block),
:mod:`repro_torch.control.scheduler` (the budget-aware round scheduler)
and :mod:`repro_torch.control.accounting` (the Rényi-DP accountants
behind the :class:`~repro_torch.comm.privacy.PrivacyAccountant`
interface).  The controller's EMA and the scheduler's state are protocol
state: they cross a checkpoint in ``SessionState.comm``.
"""
from repro_torch.control.accounting import (ACCOUNTANTS, RDPAccountant,
                                            SubsampledRDPAccountant,
                                            make_accountant, rdp_epsilon,
                                            sgm_rdp, subsampled_rdp_epsilon)
from repro_torch.control.adaptive import AdaptiveController, ServeController
from repro_torch.control.scheduler import BudgetAwareScheduler

__all__ = ["ACCOUNTANTS", "AdaptiveController", "BudgetAwareScheduler",
           "RDPAccountant", "ServeController", "SubsampledRDPAccountant",
           "make_accountant", "rdp_epsilon", "sgm_rdp",
           "subsampled_rdp_epsilon"]
