"""The port's LM serving engine (``serve.engine.ServeEngine``)."""
