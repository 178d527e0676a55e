"""``utils/precision.full_precision`` turns TF32 off for matrix products and
for cuDNN's float32 convolutions inside the context, and restores the
caller's settings after it (also after an exception)."""
import pytest
import torch

from maus_tpu_torch.utils.precision import full_precision

torch.set_num_threads(1)


@pytest.mark.parametrize("outer", [True, False])
def test_tf32_flags_off_inside_and_restored_after(outer):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        # the matmul flag follows the float32 matmul precision: "high" is TF32
        torch.set_float32_matmul_precision("high" if outer else "highest")
        torch.backends.cudnn.allow_tf32 = outer
        with pytest.raises(RuntimeError):
            with full_precision():
                assert torch.backends.cudnn.allow_tf32 is False
                assert torch.backends.cuda.matmul.allow_tf32 is False
                assert torch.get_float32_matmul_precision() == "highest"
                raise RuntimeError("leave the context by an exception")
        assert torch.backends.cudnn.allow_tf32 is outer
        assert torch.backends.cuda.matmul.allow_tf32 is outer
        assert torch.get_float32_matmul_precision() == ("high" if outer else "highest")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])
