# The ASCII interchange protocol: `engine` is the agent-session engine
# (endpoints, schedulers, transports, SessionState); `protocol` the
# back-compat front door; `scores`/`encoding` the math; `transport` the bit
# ledger.
from repro_torch.core.engine import (AgentEndpoint, Component, FittedASCII,
                                     IgnoranceMsg, InProcessTransport,
                                     MeshRingTransport, MeteredTransport,
                                     ModelWeightMsg, Protocol,
                                     RandomScheduler, Scheduler,
                                     ScoreBlockMsg, SequentialScheduler,
                                     Session, SessionConfig, SessionState,
                                     Transport, endpoints_for, holdout_split,
                                     variant_setup)

__all__ = ["AgentEndpoint", "Component", "FittedASCII", "IgnoranceMsg",
           "InProcessTransport", "MeshRingTransport", "MeteredTransport",
           "ModelWeightMsg", "Protocol", "RandomScheduler", "Scheduler",
           "ScoreBlockMsg", "SequentialScheduler", "Session", "SessionConfig",
           "SessionState", "Transport", "endpoints_for", "holdout_split",
           "variant_setup"]
