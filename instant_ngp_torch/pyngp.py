"""The pyngp module's surface on the port (port of the root ``pyngp.py``;
the reference's pybind11 module, python_api.cu): the same names, enum
aliases and ``__all__``, taken from the port's own modules.

    import instant_ngp_torch.pyngp as ngp
    testbed = ngp.Testbed()  # on the card; ngp.Testbed(device="cpu") for the plain versions
    testbed.load_training_data(scene)
    while testbed.frame(): ...
"""

from pathlib import Path

from .common import (  # noqa: F401
    BoundingBox,
    ColorSpace,
    EditingKernel,
    GroundTruthRenderMode,
    Lens,
    LensMode,
    LossType,
    MeshSdfMode,
    NerfActivation,
    RandomMode,
    RenderMode,
    SDFGroundTruthMode,
    TestbedMode,
    TonemapCurve,
    TrainMode,
)
from .render.brdf import BRDFParams  # noqa: F401
from .render.camera_path import CameraPath, CameraPathPos, Keyframe  # noqa: F401
from .render.camera_path import Keyframe as CameraKeyframe  # noqa: F401
from .render.camera_path import RenderSettings as CameraPathRenderSettings  # noqa: F401
from .render.camera_predictor import CameraPredictionMode  # noqa: F401
from .testbed import Testbed, mode_from_scene  # noqa: F401
from .testbed import _NerfTrainingView as Training  # noqa: F401


def mode_from_string(s: str) -> TestbedMode:
    """pyngp.mode_from_string (python_api.cu's mode_from_string binding)."""
    return TestbedMode(str(s).lower())


# enum aliases of pyngp's names (python_api.cu:309-430: the reference
# export_values()-s its enums into the module)
Nerf = TestbedMode.NERF
Sdf = TestbedMode.SDF
Image = TestbedMode.IMAGE
Volume = TestbedMode.VOLUME
# ELossType (SmoothL1 ≡ Huber)
SmoothL1 = LossType.HUBER
Huber = LossType.HUBER
L1 = LossType.L1
L2 = LossType.L2
RelativeL2 = LossType.RELATIVE_L2
Mape = LossType.MAPE
Smape = LossType.SMAPE
LogL1 = LossType.LOGL1
# ECameraPredictionMode (python_api.cu:401-407)
MatLogLinear = CameraPredictionMode.MAT_LOG_LINEAR
MatLogQuadratic = CameraPredictionMode.MAT_LOG_QUADRATIC
Se3LogLinear = CameraPredictionMode.SE3_LINEAR
Se3LogQuadratic = CameraPredictionMode.SE3_QUADRATIC
# ESDFGroundTruthMode (python_api.cu:364-366)
RaytracedMesh = SDFGroundTruthMode.RAYTRACED_MESH
SpheretracedMesh = SDFGroundTruthMode.SPHERETRACED_MESH
# EEditingKernel (the camera-path brush)
Gaussian = EditingKernel.GAUSSIAN
Quartic = EditingKernel.QUARTIC
Hat = EditingKernel.HAT
Box = EditingKernel.BOX

# ``ngp.path`` wraps fs::path (python_api.cu:435); pathlib's Path stands in
path = Path

__all__ = [
    "Testbed",
    "TestbedMode",
    "BoundingBox",
    "BRDFParams",
    "CameraKeyframe",
    "CameraPath",
    "CameraPathPos",
    "CameraPathRenderSettings",
    "CameraPredictionMode",
    "EditingKernel",
    "GroundTruthRenderMode",
    "Lens",
    "LensMode",
    "LossType",
    "MeshSdfMode",
    "NerfActivation",
    "RandomMode",
    "RenderMode",
    "SDFGroundTruthMode",
    "TonemapCurve",
    "TrainMode",
    "mode_from_scene",
    "mode_from_string",
    "Nerf",
    "Sdf",
    "Image",
    "Volume",
]
