"""``python -m dynamo_tpu_torch.backends.torch``: the PyTorch engine worker."""

from dynamo_tpu_torch.backends.torch.main import main

main()
