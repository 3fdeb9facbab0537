"""The host-driven paged serve path: ``ServeEngine`` and
``ContinuousBatcher`` over the refcounted ``PagePool``."""
from .engine import ContinuousBatcher, ServeConfig, ServeEngine
from .pages import PagePlan, PagePool, Reservation

__all__ = ["ContinuousBatcher", "PagePlan", "PagePool", "Reservation",
           "ServeConfig", "ServeEngine"]
