from deeplearning4j_tpu_torch.zoo.base import (  # noqa: F401
    ModelSelector,
    ZooModel,
    ZooType,
)
from deeplearning4j_tpu_torch.zoo.models import (  # noqa: F401
    VGG16,
    VGG19,
    AlexNet,
    FaceNetNN4Small2,
    GoogLeNet,
    InceptionResNetV1,
    LeNet,
    ResNet50,
    SimpleCNN,
    TextGenerationLSTM,
)
from deeplearning4j_tpu_torch.zoo.util.imagenet import (  # noqa: F401
    ImageNetLabels,
    decode_predictions,
)
