from deeplearning4j_tpu_torch.zoo.base import ZooModel  # noqa: F401
from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    VGG16,
    VGG19,
    AlexNet,
    LeNet,
    ResNet50,
    SimpleCNN,
)
