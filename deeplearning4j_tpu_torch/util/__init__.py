from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser  # noqa: F401
from deeplearning4j_tpu_torch.util.model_serializer import (  # noqa: F401
    ModelSerializer,
    restore_computation_graph,
    restore_model,
    restore_multi_layer_network,
    write_model,
)
from deeplearning4j_tpu_torch.util.nn_utils import (  # noqa: F401
    get_output_size,
    get_same_mode_bottom_right_padding,
    get_same_mode_top_left_padding,
    masked_pooling_convolution,
    masked_pooling_time_series,
    moving_average,
    reshape_2d_to_3d,
    reshape_3d_to_2d,
    reshape_time_series_mask_to_vector,
    reshape_vector_to_time_series_mask,
    reverse_time_series,
    validate_cnn_kernel_stride_padding,
)
