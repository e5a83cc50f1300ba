import sys

from tpu_gpad.cli import main
from tpu_gpad.utils.compile_cache import enable_compile_cache

enable_compile_cache()
sys.exit(main())
