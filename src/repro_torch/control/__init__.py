"""Control plane: how the channel spends its resources.

Counterpart of ``repro/control/``.  Ported so far:
:mod:`repro_torch.control.accounting`, the Rényi-DP accountants behind the
:class:`~repro_torch.comm.privacy.PrivacyAccountant` interface.  The
adaptive codec controllers and the budget-aware scheduler are a later slice
(see ROADMAP.md).
"""
from repro_torch.control.accounting import (ACCOUNTANTS, RDPAccountant,
                                            SubsampledRDPAccountant,
                                            make_accountant, rdp_epsilon,
                                            sgm_rdp, subsampled_rdp_epsilon)

__all__ = ["ACCOUNTANTS", "RDPAccountant", "SubsampledRDPAccountant",
           "make_accountant", "rdp_epsilon", "sgm_rdp",
           "subsampled_rdp_epsilon"]
