import sys

from gpubench.run import main

sys.exit(main())
