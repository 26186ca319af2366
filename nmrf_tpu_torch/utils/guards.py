"""Training-time exactness guard of the tap path (``nmrf_tpu/utils/
guards.py``).

The tap kernel B5 (``ops/msda.py:msda_taps``) is exact only while every
learned sampling offset stays within the tap radius; offsets are free in
training, so drift silently drops attention.  The train step made with
``monitor_oob=True`` reports the out-of-range share (``msda_tap_oob``, the
interval max); this guard warns above a threshold and, when the config
asks for it, requests the fallback to the exact gather path
(``TPU.MSDA_TAP_RADIUS 0``), which ``step.read_oob(guard)`` then applies.
"""

import logging


class TapOOBGuard:
    """Stateful monitor of the tap path's out-of-range share.

    check(oob) -> True exactly once, when the caller should move the step to
    the exact gather path (threshold exceeded and fallback enabled).
    Warnings repeat each time the threshold is exceeded.  A negative
    threshold disables the guard.
    """

    def __init__(self, thresh, fallback, logger=None):
        self.thresh = thresh
        self.fallback = fallback
        self.fired = False
        self.logger = logger or logging.getLogger(__name__)

    @classmethod
    def from_cfg(cls, cfg, logger=None):
        """The guard of ``TPU.MSDA_OOB_THRESH`` and ``TPU.MSDA_OOB_FALLBACK``."""
        return cls(cfg.TPU.MSDA_OOB_THRESH, cfg.TPU.MSDA_OOB_FALLBACK, logger)

    @property
    def enabled(self):
        return self.thresh >= 0

    def check(self, oob):
        if not self.enabled or oob <= self.thresh:
            return False
        self.logger.warning(
            "tap-MSDA out-of-range fraction %.3e exceeds threshold %.1e: "
            "learned sampling offsets drifted outside the tap span and "
            "their contributions are being DROPPED (ops/msda.py). %s",
            oob, self.thresh,
            "Falling back to the exact gather path (TPU.MSDA_TAP_RADIUS 0)."
            if self.fallback and not self.fired else
            "Set TPU.MSDA_OOB_FALLBACK True to auto-switch to the exact "
            "gather path, or raise TPU.MSDA_TAP_RADIUS.")
        if self.fallback and not self.fired:
            self.fired = True
            return True
        return False
