from setuptools import find_packages, setup

setup(
    name='tpudet',
    version='0.1.0',
    description='TPU-native (JAX/XLA/Pallas) object detection framework '
                'with the capabilities of mmdet-yolov4',
    packages=find_packages(include=['tpudet', 'tpudet.*', 'tpudet_torch',
                                    'tpudet_torch.*']),
    # the PyTorch/CUDA port builds its kernels from these sources on first
    # use (tpudet_torch/ops/build.py)
    package_data={'tpudet_torch.ops': ['csrc/*.cu']},
    python_requires='>=3.10',
    install_requires=[
        'jax', 'flax', 'numpy', 'msgpack',
    ],
    extras_require={
        'data': ['opencv-python'],
        'train': ['orbax-checkpoint'],
        'torch': ['torch'],
    },
)
