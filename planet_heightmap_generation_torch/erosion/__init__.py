from .composite import run_post_processing
