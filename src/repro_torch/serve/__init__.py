from repro_torch.serve.engine import Server
from repro_torch.serve.publish import (Publisher, PublishConfig, Subscriber,
                                       WeightUpdate, load_update, save_update)
from repro_torch.serve.scheduler import Request, Scheduler

__all__ = ["Server", "Publisher", "PublishConfig", "Subscriber",
           "WeightUpdate", "load_update", "save_update",
           "Request", "Scheduler"]
