"""Public home of the lockdep runtime shadow (a copy of
:mod:`multigrad_tpu.utils.lockdep`).

The implementation lives in :mod:`multigrad_tpu_torch._lockdep` — a
stdlib-only module at the package top level so that early-imported,
cycle-sensitive modules (:mod:`multigrad_tpu_torch.telemetry.metrics` is
pulled in while :mod:`multigrad_tpu_torch.parallel.mesh` is still
initializing) can use the factories without triggering this
package's heavier ``utils`` init.  Import from here in user code and
tests::

    from multigrad_tpu_torch.utils import lockdep
    lockdep.enable()
    q = FitQueue()          # locks created now are wrapped
    ...
    lockdep.crosscheck(static_edges, wildcards)

See the implementation module's docstring for the full contract
(``MGT_LOCKDEP`` / ``MGT_LOCKDEP_DUMP`` / ``MGT_LOCKDEP_HOLD_S``,
edge recording, cycle/self-deadlock/long-hold violations, and the
both-ways cross-check against the static lock graph).
"""
from .._lockdep import *  # noqa: F401,F403
from .._lockdep import (ENV_DUMP, ENV_FLAG,  # noqa: F401
                        ENV_HOLD_S, __all__)
