"""Host-side operator helpers of the PyTorch port."""
