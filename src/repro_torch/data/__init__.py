from repro_torch.data.synthetic import (calibration_batches,  # noqa: F401
                                        make_batch, request_workload,
                                        token_stream)
