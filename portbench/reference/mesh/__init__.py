from .build import SphereGraph, build_sphere, generate_fibonacci_sphere

__all__ = ["SphereGraph", "build_sphere", "generate_fibonacci_sphere"]
