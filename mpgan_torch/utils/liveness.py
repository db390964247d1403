"""Heartbeat protocol for the retryOnError supervisor's hang detection —
counterpart of ``mpgan_tpu/utils/liveness.py``.

Children (the training loop, the inference sweep) touch
``$MPGAN_HEARTBEAT`` at every unit of forward progress; the supervising
parent (:func:`mpgan_torch.utils.supervise.run_child_watched`) kills a
child whose heartbeat goes stale past ``hangTimeout``. This module is the
one definition of the touching side, shared by training and inference.
"""

from __future__ import annotations

import os


def touch_heartbeat() -> None:
    """Touch ``$MPGAN_HEARTBEAT`` if set; a no-op that never raises
    otherwise."""
    hb = os.environ.get("MPGAN_HEARTBEAT")
    if not hb:
        return
    try:
        os.utime(hb)
    except OSError:
        try:
            with open(hb, "w"):
                pass
        except OSError:
            pass
