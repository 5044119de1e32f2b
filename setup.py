#!/usr/bin/env python
"""Packaging for mxnet_tpu (reference analogue: tools/pip_package +
python/setup.py). Installs both the `mxnet_tpu` package and the `mxnet`
compatibility alias; native libs under mxnet_tpu/_lib ride along when
built (`make`)."""
from setuptools import setup, find_packages

setup(
    name="mxnet-tpu",
    version="0.11.0",
    description=("TPU-native deep-learning framework with the capability "
                 "surface of Apache MXNet v0.11 (JAX/XLA/Pallas/pjit)"),
    packages=find_packages(include=["mxnet_tpu", "mxnet_tpu.*", "mxnet",
                                    "mxnet_tpu_torch", "mxnet_tpu_torch.*"]),
    package_data={"mxnet_tpu": ["_lib/*.so"],
                  "mxnet_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
    extras_require={
        "full": ["optax", "orbax-checkpoint", "opencv-python", "pandas"],
    },
)
