"""Server entrypoint of the PyTorch port:
``python -m atoma_infer_tpu_torch.server --config-path cfg.toml``.

Ref: server/src/main.rs — clap CLI with ``--config_path`` (:22-27), env-var
overrides for address/port (:36-39,64-67), tracing init (:31). The service
runs on the CUDA device, and raises without one; ``--cpu`` serves on the CPU
(the kernels' plain versions). With ``tensor_parallel_size`` > 1 in the
configuration the service starts its other ranks itself and rank 0 runs the
HTTP app; on a host other than the first (``host_id`` > 0) this process is
a follower rank and steps in lockstep with rank 0 instead of serving.
"""

from __future__ import annotations

import argparse
import logging
import os

from ..config import EngineConfig
from ..engine.llm_service import LlmService
from .app import run_server


def main() -> None:
    parser = argparse.ArgumentParser(description="atoma-infer-tpu server")
    parser.add_argument(
        "--config-path", "--config", dest="config_path", default=None
    )
    parser.add_argument("--model", default=None, help="model dir or HF id")
    parser.add_argument(
        "--host", default=os.environ.get("SERVER_ADDRESS", "0.0.0.0")
    )
    parser.add_argument(
        "--port", type=int, default=int(os.environ.get("SERVER_PORT", "8080"))
    )
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument(
        "--warmup", action="store_true",
        help="run synthetic request waves at the configured bucket shapes "
        "before binding the listener: on the card they capture the "
        "steps' CUDA graphs, every rank's under tensor parallelism "
        "(LlmService.warmup)",
    )
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args()

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )

    if args.config_path:
        config = EngineConfig.from_file_path(args.config_path)
    else:
        config = EngineConfig.from_env()
    if args.model:
        config.model.model_name = args.model

    service = LlmService.start(config, device="cpu" if args.cpu else None)
    if service.group is not None and not service.group.is_primary:
        from ..engine.multihost import follower_loop

        follower_loop(service)
        service.stop()
        return
    run_server(service, host=args.host, port=args.port, warmup=args.warmup)


if __name__ == "__main__":
    main()
