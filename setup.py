"""Build the native core extension (CPython C API; no pybind11 in this image).

Usage: ``python setup.py build_ext --inplace`` — produces ``cyten_tpu/_core*.so``.
The package works without it (pure-python fallback in ``cyten_tpu/_native.py``).
"""

from setuptools import Extension, setup

setup(
    name='cyten_tpu',
    version='0.1.0',
    packages=['cyten_tpu', 'cyten_tpu_torch'],
    ext_modules=[
        Extension(
            'cyten_tpu._core',
            sources=['native/core.cpp'],
            extra_compile_args=['-O3', '-std=c++17'],
            language='c++',
        ),
    ],
)
