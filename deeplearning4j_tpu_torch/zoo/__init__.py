from deeplearning4j_tpu_torch.zoo.base import ZooModel  # noqa: F401
from deeplearning4j_tpu_torch.zoo.models import ResNet50  # noqa: F401
