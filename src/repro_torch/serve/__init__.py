"""The paged serve path: ``ServeEngine`` with the host-driven
``ContinuousBatcher`` and the fused ``DeviceContinuousBatcher`` over the
refcounted ``PagePool``."""
from .engine import (ContinuousBatcher, DeviceContinuousBatcher, ServeConfig,
                     ServeEngine)
from .pages import PagePlan, PagePool, Reservation

__all__ = ["ContinuousBatcher", "DeviceContinuousBatcher", "PagePlan",
           "PagePool", "Reservation", "ServeConfig", "ServeEngine"]
