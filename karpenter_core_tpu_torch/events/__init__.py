from .recorder import Event, Recorder
