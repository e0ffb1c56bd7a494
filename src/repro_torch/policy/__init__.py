"""Policy engine on the changelog fabric (Robinhood + HSM action
stream analogue): namespace mirror (ground truth), declarative rules
emitting an action lifecycle stream, and the reconciler that audits
the invariant between them."""

from .engine import (FAILED, STARTED, SUCCEED, WAITING, Action,
                     PolicyEngine, PolicyRule)
from .mirror import MIRROR_TYPES, MirrorEntry, NamespaceMirror
from .reconciler import (ActionState, ReconcileReport, reconcile,
                         replay_action_state)

__all__ = ["NamespaceMirror", "MirrorEntry", "MIRROR_TYPES",
           "PolicyRule", "PolicyEngine", "Action",
           "WAITING", "STARTED", "SUCCEED", "FAILED",
           "reconcile", "replay_action_state", "ReconcileReport",
           "ActionState"]
