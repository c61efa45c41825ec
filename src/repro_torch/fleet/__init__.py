"""Fleet history and drift analytics (numpy; copies of ``repro.fleet``'s
``store`` and ``drift``). The scoring service comes later."""
