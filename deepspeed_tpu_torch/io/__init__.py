"""Fast checkpoint I/O (ref deepspeed/io/)."""

from deepspeed_tpu_torch.io.fast_file_writer import (FastFileWriter,
                                                     MockFileWriter,
                                                     PyFileWriter,
                                                     read_tensor_file,
                                                     write_tensor_file)

__all__ = ["FastFileWriter", "PyFileWriter", "MockFileWriter",
           "write_tensor_file", "read_tensor_file"]
