"""Models of the port: the double-integrator dynamics and the collision
prediction network."""

from .collision_net import CollisionNet
from .double_integrator import DoubleIntegrator2D

__all__ = ["CollisionNet", "DoubleIntegrator2D"]
